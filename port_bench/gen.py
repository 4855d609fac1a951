"""What the ENS-I2V entries share: the surrogates' FLOPs and the rebuild
kernels' bytes for the work a window did, and the comparisons with the
reference's Adam steps.

Each number compared is a gap of norms taken by the worst leaf, a leaf
being one clip's share of a tensor: the gap between the program's norm and
the reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger. Leaves whose first moment in the reference is
under a thousandth of the median leaf's are left out of the norms (none are
at these cells' sizes)."""

from __future__ import annotations

import torch

from . import flops
from .reference import i2v as ref_i2v
from .reference import surrogates as ref_surrogates


def work(config: dict, batch: int, counts: dict) -> dict:
    """FLOPs and rebuild bytes of ``counts['steps']`` Adam steps in
    ``counts['calls']`` calls at ``batch`` clips: a step's forward and
    input-gradient, a call's one clean-tap forward; a step's K1 and K2
    each cover every frame once, and each call's final rebuild K1 once."""
    n_frames, hw = batch * config["frames"], config["hw"]
    with torch.device("meta"):
        models = [ref_surrogates.build(n, d, config.get("tiny", False))
                  for n, d in config["surrogates"]]
    step, clean = flops.gen_flops(models, n_frames, hw)
    steps, calls = counts.get("steps", 0), counts.get("calls", 0)
    numel = n_frames * 3 * hw * hw
    return {"flops": steps * step + calls * clean,
            "rebuild_bytes": {
                "rebuild_fwd_kernel": (steps + calls) * flops.rebuild_fwd_bytes(numel),
                "rebuild_bwd_kernel": steps * flops.rebuild_bwd_bytes(numel)}}


def reference_run(config: dict, models, clean_frames: torch.Tensor, steps: int, init=None):
    return ref_i2v.adam_attack(models, clean_frames, steps=steps, lr=config["lr"],
                               epsilon=config["epsilon"], block=config["reference_block"],
                               init=init)


def leaf_norms(x: torch.Tensor, leaves: int) -> torch.Tensor:
    return torch.linalg.vector_norm(x.reshape(leaves, -1).double(), dim=1)


def norm_gap(prog: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor) -> float:
    prog, ref = prog[keep], ref[keep]
    scale = torch.clamp(ref, min=float(torch.median(ref)))
    return float(torch.max(torch.abs(prog - ref) / scale))


def loss_gap(prog, ref) -> float:
    prog, ref = torch.as_tensor(prog).double(), torch.as_tensor(ref).double()
    return float(torch.max(torch.abs(prog - ref) / torch.abs(ref)))
