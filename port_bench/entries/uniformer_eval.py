"""UniFormer-B over a set of adversarial artifacts through
``eval/transfer.py``'s ``single_pass_eval``, as :mod:`.swin_eval` runs Swin-B:
the same sweeps, batches, spies on the timed path's logits, check against
the reference's logits of the same files, and a whole sweep in set-up.
What is its own: the models (the port's ``uniformer_b`` and the plain
:mod:`port_bench.reference.uniformer`, built from the configuration's
keys), every LayerNorm weight and every BatchNorm scale drawn as 1 + N(0,
0.01) on both sides (:func:`norms_about_one_`: the seeded draw gives a 1-D
parameter N(0, 0.01), under which each conv block's branches would be ~1e-2
of the residual and the attention's scores ~1e-4, below the check's sight),
and the work: the reference's FLOPs a clip and each launch of the depthwise
conv kernel (:mod:`port_bench.dwconv3d`)."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.nn as nn

from port_bench import build, dwconv3d, flops, traffic as gen_traffic, weights
from port_bench.entries import swin_eval
from port_bench.reference import uniformer as ref_uniformer


def norms_about_one_(module: nn.Module) -> nn.Module:
    """The weight of every norm (a module named ``norm``, ``norm1`` or
    ``norm2``: the LayerNorms and the BatchNorms' scales), drawn N(0, 0.01),
    moved to 1 + N(0, 0.01)."""
    with torch.no_grad():
        for name, m in module.named_modules():
            if name.rsplit(".", 1)[-1].startswith("norm"):
                m.weight.add_(1.0)
    return module


def reference_uniformer(index: int, config: dict, seed: int, device) -> nn.Module:
    with torch.device("meta"):
        module = ref_uniformer.build(config)
    module = weights.fill_(module.to_empty(device=device), seed, build.VIDEO_STREAM + index)
    return norms_about_one_(module)


class Entry(swin_eval.Entry):
    def setup(self) -> None:
        from i2v_tpu_torch.parallel.replicas import replicas_for
        from i2v_tpu_torch.utils import artifacts

        cfg = self.config
        # the models first: a program without them stops before any artifact is written
        self.bundles = {}
        for i, name in enumerate(cfg["models"]):
            bundle = build.port_video(name, i, cfg, self.seed, self.device, self.dtype)
            norms_about_one_(bundle.module)
            self.bundles[name] = bundle
        self.dir = tempfile.mkdtemp(prefix="port_bench_artifacts_")
        gen_traffic.write_artifacts(self.dir, self.traffic["artifacts"], cfg["frames"], cfg["hw"],
                                    self.traffic["epsilon"], self.seed, self.device)
        self.files = artifacts.list_adv_files(self.dir)
        self.order = [i % len(self.files) for i in range(self.traffic["sweep_clips"])]
        self.batches = artifacts.batch_files([self.files[i] for i in self.order],
                                             self.traffic["batch"])
        self.logits: dict = {}
        self.calls = dict.fromkeys(self.bundles, 0)
        for name, bundle in self.bundles.items():
            replicas = replicas_for(bundle, None, graphs=True)
            replicas.predict = self._spy(name, replicas.predict)
        self.sweeps: list = []
        # a whole sweep, as Swin's set-up makes: the capture and the pinned
        # buffers the window's sweeps cycle through
        self._evaluate(self.batches)
        self.calls = dict.fromkeys(self.bundles, 0)

    def work(self, counts: dict) -> dict:
        cfg = self.config
        with torch.device("meta"):
            model = ref_uniformer.build(cfg)
        per_clip = flops.forward_flops(model, (1, 3, cfg["frames"], cfg["hw"], cfg["hw"]))
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        launches = [w for batch in self.batches
                    for w in dwconv3d.launch_work(cfg, len(batch), itemsize)]
        return {"flops": counts.get("clips", 0) * per_clip,
                "dwconv3d": [(f, b, counts.get("sweeps", 0)) for f, b in launches]}

    def _reference_logits(self, index: int, name: str) -> torch.Tensor:
        model = reference_uniformer(index, self.config, self.seed, self.device)
        out, block = [], self.config["reference_block"]
        with torch.no_grad():
            for i in range(0, len(self.files), block):
                x = np.stack([np.load(os.path.join(self.dir, f))
                              for f in self.files[i:i + block]])
                out.append(model(torch.from_numpy(x).to(self.device)))
        return torch.cat(out).double()
