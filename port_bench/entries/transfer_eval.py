"""The six video classifiers over a set of adversarial artifacts through
``eval/transfer.py``'s ``single_pass_eval``: each batch read and uploaded
once, all six models resident (the fused path's and the 400-clip run's
order). The models stay resident across sweeps.

Set-up writes the artifacts from the seed under ``TMPDIR``, builds the six
models and evaluates the first two batches, which captures each model's
forward (a batch shape's first forward is eager, its second captured). A unit of
the window is one sweep: one call of the evaluation over ``sweep_clips``
clips, the artifacts listed in turn as often as that takes (a sweep's reads
come from the page cache either way, and its prefetch pipeline fills once,
as an evaluation job's does). Each model's logits of
every batch are read where the timed path returns them (``Replicas.predict``,
the replayed forward), and the check compares the last sweep's logits and
every sweep's predictions with the reference's logits of the same files."""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from port_bench import build, traffic as gen_traffic


def _quiet(*args, **kwargs) -> None:
    pass


class Entry:
    def __init__(self, *, cell, config, traffic, seed, device, dtype):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.limits = cell["limits"]
        self.dtype = dtype
        self.dir = None

    def setup(self) -> None:
        from i2v_tpu_torch.parallel.replicas import replicas_for
        from i2v_tpu_torch.utils import artifacts

        cfg = self.config
        self.dir = tempfile.mkdtemp(prefix="port_bench_artifacts_")
        gen_traffic.write_artifacts(self.dir, self.traffic["artifacts"], cfg["frames"], cfg["hw"],
                                    self.traffic["epsilon"], self.seed, self.device)
        self.files = artifacts.list_adv_files(self.dir)
        # the artifact behind each clip of a sweep
        self.order = [i % len(self.files) for i in range(self.traffic["sweep_clips"])]
        self.batches = artifacts.batch_files([self.files[i] for i in self.order],
                                             self.traffic["batch"])
        self.bundles = {name: build.port_video(name, i, cfg, self.seed, self.device, self.dtype)
                        for i, name in enumerate(cfg["models"])}
        self.logits: dict = {}
        self.calls = dict.fromkeys(self.bundles, 0)
        for name, bundle in self.bundles.items():
            replicas = replicas_for(bundle, None, graphs=True)
            replicas.predict = self._spy(name, replicas.predict)
        self.sweeps: list = []
        self._evaluate(self.batches[:2])
        self.calls = dict.fromkeys(self.bundles, 0)

    def _spy(self, name: str, predict):
        def spy(clips, positions, labels=None):
            out = predict(clips, positions, labels)
            self.logits[(name, self.calls[name] % len(self.batches))] = out[0].clone()
            self.calls[name] += 1
            return out

        return spy

    def _evaluate(self, batches):
        from i2v_tpu_torch.eval import transfer

        preds, labels, _ = transfer.single_pass_eval(self.bundles, batches, self.dir, log=_quiet)
        return preds, labels

    def _sweep(self) -> int:
        preds, labels = self._evaluate(self.batches)
        self.sweeps.append((preds, labels))
        return len(labels)

    def unit(self) -> dict:
        n = self._sweep()
        return {"clips": n, "batches": len(self.batches), "attempted": len(self.batches),
                "sweeps": 1}

    def work(self, counts: dict) -> dict:
        from port_bench import flops

        cfg = self.config
        shape = (1, 3, cfg["frames"], cfg["hw"], cfg["hw"])
        per_clip = 0
        for name in cfg["models"]:
            with torch.device("meta"):
                model = build.ref_video.build(name, cfg.get("tiny", False))
            per_clip += flops.forward_flops(model, shape)
        return {"flops": counts.get("clips", 0) * per_clip}

    def release(self) -> None:
        self.bundles = None

    def _reference_logits(self, index: int, name: str) -> torch.Tensor:
        model = build.reference_video(name, index, self.config, self.seed, self.device)
        out, block = [], self.config["reference_block"]
        with torch.no_grad():
            for i in range(0, len(self.files), block):
                x = np.stack([np.load(os.path.join(self.dir, f))
                              for f in self.files[i:i + block]])
                out.append(model(torch.from_numpy(x).to(self.device)))
        return torch.cat(out).double()

    def check(self) -> dict:
        logit_gap = pred_gap = 0.0
        bsz = self.traffic["batch"]
        for i, name in enumerate(self.config["models"]):
            ref = self._reference_logits(i, name)
            scale = ref.std(dim=1)
            rows = torch.tensor(self.order, device=self.device)
            for b in range(len(self.batches)):
                got = self.logits[(name, b)].double().to(self.device)
                at = rows[b * bsz:b * bsz + got.shape[0]]
                logit_gap = max(logit_gap, float(torch.max(
                    torch.max(torch.abs(got - ref[at]), dim=1).values / scale[at])))
            ref, scale = ref[rows], scale[rows]
            best = ref.max(dim=1).values
            for preds, _ in self.sweeps:
                p = torch.as_tensor(preds[name], device=self.device)
                chosen = ref.gather(1, p[:, None])[:, 0]
                pred_gap = max(pred_gap, float(torch.max((best - chosen) / scale)))
        return {"logit_gap": (logit_gap, self.limits["logit_gap"]),
                "pred_gap": (pred_gap, self.limits["pred_gap"])}

    def close(self) -> None:
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
