"""MViTv2-B over a set of adversarial artifacts through
``eval/transfer.py``'s ``single_pass_eval``, as :mod:`.swin_eval` runs Swin-B:
the same sweeps, batches, spies on the timed path's logits, check against
the reference's logits of the same files, every LayerNorm weight drawn as
1 + N(0, 0.01) on both sides (the seeded draw gives a 1-D parameter
N(0, 0.01), under which the pooled and normalised q, k and v would be
~1e-2, and both the products and the relative terms would shrink below the
check's sight), and a whole sweep in set-up. What is its own: the models
(the port's ``mvit_v2_b`` and the plain :mod:`port_bench.reference.mvit`,
built from the configuration's keys) and the work: the reference's FLOPs a
clip and each launch of the pooling-attention kernel
(:mod:`port_bench.pool_attn`)."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn

from port_bench import build, flops, pool_attn, weights
from port_bench.entries import swin_eval
from port_bench.reference import mvit as ref_mvit


def reference_mvit(index: int, config: dict, seed: int, device) -> nn.Module:
    with torch.device("meta"):
        module = ref_mvit.build(config)
    module = weights.fill_(module.to_empty(device=device), seed, build.VIDEO_STREAM + index)
    return swin_eval.layer_norms_about_one_(module)


class Entry(swin_eval.Entry):
    def work(self, counts: dict) -> dict:
        cfg = self.config
        with torch.device("meta"):
            model = ref_mvit.build(cfg)
        per_clip = flops.forward_flops(model, (1, 3, cfg["frames"], cfg["hw"], cfg["hw"]))
        launches = [w for batch in self.batches
                    for w in pool_attn.launch_work(cfg, len(batch))]
        return {"flops": counts.get("clips", 0) * per_clip,
                "pool_attn": [(f, b, counts.get("sweeps", 0)) for f, b in launches]}

    def _reference_logits(self, index: int, name: str) -> torch.Tensor:
        model = reference_mvit(index, self.config, self.seed, self.device)
        out, block = [], self.config["reference_block"]
        with torch.no_grad():
            for i in range(0, len(self.files), block):
                x = np.stack([np.load(os.path.join(self.dir, f))
                              for f in self.files[i:i + block]])
                out.append(model(torch.from_numpy(x).to(self.device)))
        return torch.cat(out).double()
