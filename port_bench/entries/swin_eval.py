"""Video Swin-B over a set of adversarial artifacts through
``eval/transfer.py``'s ``single_pass_eval``, as :mod:`.transfer_eval` runs
the six classifiers: the same sweeps, batches, spies on the timed path's
logits and check against the reference's logits of the same files. What
is its own: the models (the port's ``swin3d_b`` and the plain
:mod:`port_bench.reference.swin3d`), every LayerNorm weight drawn as 1 +
N(0, 0.01) on both sides (the seeded draw gives a 1-D parameter N(0, 0.01),
under which q·kᵀ would be a few ten-thousandths of the relative bias, too
small for the check to see it dropped), and the work: the reference's FLOPs
a clip and each launch of the window-attention kernel
(:mod:`port_bench.window_attn`); and set-up's first sweep is a whole one."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.nn as nn

from port_bench import build, flops, traffic as gen_traffic, weights
from port_bench import window_attn
from port_bench.entries import transfer_eval
from port_bench.reference import swin3d as ref_swin3d


def layer_norms_about_one_(module: nn.Module) -> nn.Module:
    """Every LayerNorm weight, drawn N(0, 0.01), moved to 1 + N(0, 0.01)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.add_(1.0)
    return module


def reference_swin(index: int, config: dict, seed: int, device) -> nn.Module:
    with torch.device("meta"):
        module = ref_swin3d.build(config["models"][index], config.get("tiny", False))
    module = weights.fill_(module.to_empty(device=device), seed, build.VIDEO_STREAM + index)
    return layer_norms_about_one_(module)


class Entry(transfer_eval.Entry):
    def setup(self) -> None:
        from i2v_tpu_torch.parallel.replicas import replicas_for
        from i2v_tpu_torch.utils import artifacts

        cfg = self.config
        # the models first: a program without them stops before any artifact is written
        self.bundles = {}
        for i, name in enumerate(cfg["models"]):
            bundle = build.port_video(name, i, cfg, self.seed, self.device, self.dtype)
            layer_norms_about_one_(bundle.module)
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
        # a whole sweep, not two batches: beside the capture (a batch shape's
        # second forward), it leaves in PyTorch's host cache the pinned
        # buffers the prefetch pipeline cycles through, which the window's
        # first sweep would otherwise allocate (0.1-0.35 s of a 2.2 s sweep)
        self._evaluate(self.batches)
        self.calls = dict.fromkeys(self.bundles, 0)

    def work(self, counts: dict) -> dict:
        cfg = self.config
        shape = (1, 3, cfg["frames"], cfg["hw"], cfg["hw"])
        with torch.device("meta"):
            model = ref_swin3d.build(cfg["models"][0], cfg.get("tiny", False))
        per_clip = flops.forward_flops(model, shape)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        launches = [w for batch in self.batches
                    for w in window_attn.launch_work(cfg, len(batch), itemsize)]
        return {"flops": counts.get("clips", 0) * per_clip,
                "window_attn": [(f, b, counts.get("sweeps", 0)) for f, b in launches]}

    def _reference_logits(self, index: int, name: str) -> torch.Tensor:
        model = reference_swin(index, self.config, self.seed, self.device)
        out, block = [], self.config["reference_block"]
        with torch.no_grad():
            for i in range(0, len(self.files), block):
                x = np.stack([np.load(os.path.join(self.dir, f))
                              for f in self.files[i:i + block]])
                out.append(model(torch.from_numpy(x).to(self.device)))
        return torch.cat(out).double()
