"""Coarse-to-fine (multigrid) schedule for the I2V / ENS-I2V attacks.

PyTorch counterpart of :mod:`i2v_tpu.parallel.multigrid`. The first K of the
Adam steps run on ``scale``-times area-downsampled clips (1/scale² of the
surrogate work a step); the coarse modifier, block-repeated up to full size,
warm-starts the remaining steps at full resolution. It is an opt-in
approximation (``image_main --multigrid K``): the trajectory differs from
the reference's. The ε-ball and [0,1] hold in both phases, since the
modifier is clipped inside ``rebuild_adv`` at either size, and the cost
vector is the coarse costs followed by the fine ones.

The coarse phase is a runner (:func:`~.sharded.make_sharded_i2v_runner`, or
another ``runner_factory`` such as
:func:`~.ensemble.make_ensemble_parallel_runner`) over the downsampled clips
that returns its final modifier; the fine phase is another one on the same
mesh, warm-started through ``mod_init``. The Adam moments restart at the
switch: the coarse ones live on another grid. Adaptive AENS is refused, as
in the JAX package: its per-tap signal changes magnitude with the frame
area. Surrogates built to compute in bfloat16 run both phases in it, with
``param_dtype`` cast once and shared (``i2v_tpu/parallel/multigrid.py:93-111``),
and ``"auto"`` chunks each phase by their dtype: the coarse 112² phase of a
bfloat16 ensemble fits 2048 frames a chunk.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from ..models.api import ImageModel
from .mesh import Mesh, Sharded
from .sharded import cast_param_storage, make_sharded_i2v_runner


def downsample_clips(clean01: torch.Tensor, scale: int) -> torch.Tensor:
    """(B,C,T,H,W) → (B,C,T,H/s,W/s), the exact area mean (s must divide H
    and W)."""
    b, c, t, h, w = clean01.shape
    if h % scale or w % scale:
        raise ValueError(f"multigrid scale {scale} must divide the spatial size ({h}×{w})")
    return clean01.reshape(b, c, t, h // scale, scale, w // scale, scale).mean(dim=(4, 6))


def upsample_modifier(mod_frames: torch.Tensor, scale: int) -> torch.Tensor:
    """(N,3,h,w) → (N,3,h·s,w·s), a nearest (block-repeat) upsample: the warm
    start keeps the coarse optimum's values, inside the same ±ε box."""
    return mod_frames.repeat_interleave(scale, dim=2).repeat_interleave(scale, dim=3)


def make_multigrid_i2v_runner(
    models: Sequence[ImageModel],
    mesh: Optional[Mesh] = None,
    *,
    steps: int,
    coarse_steps: int,
    scale: int = 2,
    step_size: float = 0.005,
    epsilon: float = 16 / 255,
    frame_chunk: int | str | None = None,
    coarse_frame_chunk=...,
    param_dtype: Optional[torch.dtype] = None,
    runner_factory=None,
    graphs: bool = True,
):
    """Two-phase runner: ``runner(clean01, n_real=None) -> (adv01 clips,
    per-step costs)`` with ``len(costs) == steps`` (coarse, then fine).
    ``coarse_frame_chunk`` defaults to ``frame_chunk`` ("auto" resolves
    again at the coarse size). Each phase keeps its own step graph, one a
    shape (``graphs``, the default runner's keyword). ``runner_factory(models, mesh, steps=,
    step_size=, epsilon=, frame_chunk=, return_modifier=)`` builds each
    phase (default :func:`~.sharded.make_sharded_i2v_runner`; with no
    ``mesh``, on the surrogates' device)."""
    if not 0 < coarse_steps < steps:
        raise ValueError(f"coarse_steps must be in (0, {steps}), got {coarse_steps}")
    if scale < 2:
        raise ValueError(f"multigrid scale must be ≥ 2, got {scale}")
    if param_dtype is not None:
        # cast once, and both phases share the copy
        models = cast_param_storage(models, param_dtype)
    if coarse_frame_chunk is ...:
        coarse_frame_chunk = frame_chunk
    factory = runner_factory or functools.partial(make_sharded_i2v_runner, graphs=graphs)
    coarse = factory(models, mesh, steps=coarse_steps, step_size=step_size, epsilon=epsilon,
                     frame_chunk=coarse_frame_chunk, return_modifier=True)
    fine = factory(models, mesh, steps=steps - coarse_steps, step_size=step_size,
                   epsilon=epsilon, frame_chunk=frame_chunk)

    def runner(clean01, n_real=None):
        # the area mean needs whole clips: a laid-out batch is gathered
        clean01 = clean01.gather() if isinstance(clean01, Sharded) else torch.as_tensor(clean01)
        _, costs_c, mod_c = coarse(downsample_clips(clean01, scale), n_real=n_real)
        adv, costs_f = fine(clean01, n_real=n_real, mod_init=upsample_modifier(mod_c, scale))
        return adv, torch.cat([costs_c, costs_f])

    return runner
