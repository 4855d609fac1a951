"""ENS-I2V at one clip a call through the Adam engine that ``image_main``
uses without ``--sharded`` (``attacks/i2v.py``:
``ImageGuidedFML2_Adam_MultiModels`` → ``run_adam_modifier_attack``): one
whole 60-step call a clip, its clean taps, final rebuild and hand-back
included, the clip handed in normalized and handed back normalized as
``image_main`` does.

The attack object is built once: set-up makes its first call, on the first
clip (which warms up and captures the step), and the window carries on
with the same object over a pool of clips. Every call starts from the
fill, so the check follows the window's last call in the reference, from
the same clip and weights: each step's cost (from the attack's
``loss_info``), the change the call made to the clip, and that the clip
stays within ε of the clean one and within [0,1]."""

from __future__ import annotations

import torch

from port_bench import build, gen, traffic as gen_traffic
from port_bench.reference import i2v as ref_i2v


class Entry:
    def __init__(self, *, cell, config, traffic, seed, device, dtype):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.limits = cell["limits"]
        self.dtype = dtype
        self.steps = config["steps"]

    def _clip(self, k: int) -> torch.Tensor:
        return gen_traffic.clips01(1, self.config["frames"], self.config["hw"], self.seed,
                                   gen_traffic.CLIP_STREAM + k, self.device)

    def _call(self, k: int) -> None:
        self.last = None  # the previous call's clip goes before this call
        self.last = (k, self.attack(self.pool[k], [k], video_names=[str(k)]))

    def setup(self) -> None:
        from i2v_tpu_torch.attacks.i2v import ImageGuidedFML2_Adam_MultiModels

        self.models = build.port_surrogates(self.config, self.seed, self.device, self.dtype)
        self.pool = [gen_traffic.normalize(self._clip(k))
                     for k in range(self.traffic["pool_clips"])]
        self.attack = ImageGuidedFML2_Adam_MultiModels(
            self.models, epsilon=self.config["epsilon"], steps=self.steps, graphs=True)
        self.at = 0
        self._call(self.at)

    def unit(self) -> dict:
        self.at = (self.at + 1) % len(self.pool)
        self._call(self.at)
        return {"steps": self.steps, "calls": 1, "attempted": 1, "clip_steps": self.steps}

    def work(self, counts: dict) -> dict:
        return gen.work(self.config, 1, counts)

    def release(self) -> None:
        k, adv = self.last
        self.last = {"k": k, "adv": adv, "costs": [
            float(v["cost"]) for _, v in sorted(self.attack.loss_info[str(k)].items())]}
        self.models = self.pool = self.attack = None

    def check(self) -> dict:
        clean = ref_i2v.flatten(self._clip(self.last["k"]))
        models = build.reference_surrogates(self.config, self.seed, self.device)
        costs, mod, _ = gen.reference_run(self.config, models, clean, self.steps)
        adv01 = ref_i2v.flatten(self.last["adv"]) \
            * torch.tensor(gen_traffic.STD, device=self.device).reshape(1, 3, 1, 1) \
            + torch.tensor(gen_traffic.MEAN, device=self.device).reshape(1, 3, 1, 1)
        adv_ref = ref_i2v.rebuild(clean, mod, self.config["epsilon"])
        keep = torch.ones(1, dtype=torch.bool, device=self.device)
        lim = self.limits
        return {
            "loss_gap": (gen.loss_gap(self.last["costs"], costs), lim["loss_gap"]),
            "change_gap": (gen.norm_gap(gen.leaf_norms(adv01 - clean, 1),
                                        gen.leaf_norms(adv_ref - clean, 1), keep),
                           lim["change_gap"]),
            # the ε-ball and [0,1]: the clip comes back normalized, so its
            # round trip rounds by a few float32 ulps
            "range_err": (float(max(torch.max(torch.abs(adv01 - clean)) - self.config["epsilon"],
                                    -torch.min(adv01), torch.max(adv01) - 1.0, 0.0)),
                          lim["range_err"]),
        }

    def close(self) -> None:
        pass
