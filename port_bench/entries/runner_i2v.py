"""ENS-I2V through the frame-chunked runner (``parallel/sharded.py``), the
path of ``image_main --sharded --frame_chunk auto``.

A 60-step batch runs as calls of ``steps_per_call`` steps; each call after
a batch's first resumes the modifier and Adam's state through the runner's
``mod_init``, ``opt_init``, ``return_modifier`` and ``opt_state_io``, as a
resumed 400-clip run does, and a new batch from the seed starts once a
batch has had its steps. The runner is built once: set-up makes a batch's
first call from the fresh 0.01/255 fill (which warms up and captures the
step), and the window carries on with the same object.

The check follows two calls in the reference, from the same clips and
weights: set-up's first call from the fill, and the window's last call
resumed from the modifier and Adam state that the port handed to it (the
reference cannot reach that state itself within a window's time). Each
compares each step's cost, each clip's Adam first moment and modifier
change over the call, and the returned clips against the plain rebuild of
the returned modifier (K1 is exact)."""

from __future__ import annotations

import torch

from port_bench import build, gen, traffic as gen_traffic
from port_bench.reference import i2v as ref_i2v


class Entry:
    def __init__(self, *, cell, config, traffic, seed, device, dtype):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.limits = cell["limits"]
        self.dtype = dtype
        self.batch = traffic["batch"]
        self.steps = traffic["steps_per_call"]
        self.calls_per_batch = config["steps"] // self.steps

    def _clips(self, k: int) -> torch.Tensor:
        return gen_traffic.clips01(self.batch, self.config["frames"], self.config["hw"],
                                   self.seed, gen_traffic.CLIP_STREAM + k, self.device)

    def _call(self, init) -> None:
        """One runner call on batch ``self.at``, from ``init = (modifier,
        Adam's state)`` or, None, from the fill; kept as ``self.last``."""
        self.last = None  # the previous call's outputs go before this call's
        if init is None:
            adv, costs, mod, opt = self.runner(self.clips)
        else:
            adv, costs, mod, opt = self.runner(self.clips, mod_init=init[0], opt_init=init[1])
        self.last = {"batch": self.at, "init": init, "adv": adv, "costs": costs, "mod": mod,
                     "opt": opt}
        self.state, self.call = (mod, opt), self.call + 1

    def setup(self) -> None:
        from i2v_tpu_torch.parallel.sharded import make_sharded_i2v_runner

        self.models = build.port_surrogates(self.config, self.seed, self.device, self.dtype)
        self.at, self.call = 0, 0
        self.clips = self._clips(self.at)
        self.runner = make_sharded_i2v_runner(
            self.models, steps=self.steps, step_size=self.config["lr"],
            epsilon=self.config["epsilon"], frame_chunk=self.traffic["frame_chunk"],
            return_modifier=True, opt_state_io=True, graphs=True)
        self._call(None)
        self.first = {k: self.last[k].cpu() for k in ("costs", "adv", "mod")}
        self.first["exp_avg"] = self.last["opt"][1].cpu()

    def unit(self) -> dict:
        if self.call == self.calls_per_batch:
            self.at, self.call, self.state = self.at + 1, 0, None
            self.clips = self._clips(self.at)
        self._call(self.state)
        return {"steps": self.steps, "calls": 1, "attempted": 1,
                "clip_steps": self.batch * self.steps}

    def work(self, counts: dict) -> dict:
        return gen.work(self.config, self.batch, counts)

    def release(self) -> None:
        self.models = self.clips = self.runner = self.state = None

    def _compare(self, got: dict, clean: torch.Tensor, init, models) -> dict:
        costs, mod, exp_avg = gen.reference_run(self.config, models, clean, self.steps, init)
        mod0 = torch.full_like(mod, ref_i2v.MODIFIER_INIT) if init is None else init[0]
        m_ref = gen.leaf_norms(exp_avg, self.batch)
        keep = m_ref >= 1e-3 * torch.median(m_ref)
        got_mod = got["mod"].to(self.device)
        adv = ref_i2v.flatten(got["adv"].to(self.device))
        rebuilt = ref_i2v.rebuild(clean, got_mod, self.config["epsilon"])
        return {
            "loss_gap": gen.loss_gap(got["costs"].cpu(), costs),
            "grad_gap": gen.norm_gap(gen.leaf_norms(got["exp_avg"].to(self.device), self.batch),
                                     m_ref, keep),
            "change_gap": gen.norm_gap(gen.leaf_norms(got_mod - mod0, self.batch),
                                       gen.leaf_norms(mod - mod0, self.batch), keep),
            "rebuild_err": float(torch.max(torch.abs(adv - rebuilt))),
        }

    def check(self) -> dict:
        models = build.reference_surrogates(self.config, self.seed, self.device)
        last, self.last = dict(self.last, exp_avg=self.last["opt"][1]), None
        out = {}
        for prefix, got, k, init in (("", last, last["batch"], last["init"]),
                                     ("first_", self.first, 0, None)):
            clean = ref_i2v.flatten(self._clips(k))
            for name, value in self._compare(got, clean, init, models).items():
                out[prefix + name] = (value, self.limits[prefix + name])
        return out

    def close(self) -> None:
        pass
