"""Ensemble (model-axis) parallelism for ENS-I2V and AENS-I2V-MF.

PyTorch counterpart of :mod:`i2v_tpu.parallel.ensemble`. The reference
forwards its four surrogates one after another every step
(image_attacks.py:469-480). Here the surrogates split into groups over the
``model`` axis of a ``('model', 'frames')`` mesh, and the frame batch over
its ``frames`` axis: position (g, f) runs group g's forward and backward on
frame slice f only, so each step costs one group's work a device. Slice f's
modifier and Adam state live on its home device, position (0, f); each
step the gradients of its positions are summed there over g (the JAX
``psum`` over ``'model'``), and the cost over every position on position
(0, 0)'s device, in position order. The runner keeps its static buffers
and step graphs a batch layout (``sharded._Loop`` over the grid of
positions): on a card each position's chunks are a CUDA graph on its card,
and each slice's Adam step (``utils.graphs.TableAdam``) a graph on its
home, as the JAX runner is one ``jit`` of one scan a shape
(``i2v_tpu/parallel/ensemble.py:258-315``).

Each position keeps only its own group's clean taps. (The JAX runner's
zero-padded flat tap buffer, ``i2v_tpu/parallel/ensemble.py:127-192``,
exists because ``lax.switch`` branches must return one structure; a
position here holds its own list.) AENS's coefficients are one vector on
position (0, 0)'s device: group g's taps sit at a static offset in it, each
position adds its per-tap signal into its group's part, and the
coefficients persist across runner calls.

Only the layout is this module's: the grid of positions, their replicas and
tap slices, and the chunk rule. The call, the loops by layout and
``value_and_grad`` are the frame-sharded runner's own body
(``sharded._make_runner``), and :class:`EnsembleParallelAttack` is its
attack wrapper (``sharded.ShardedImageGuidedAttack``).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..models.api import ImageModel
from .mesh import Mesh, local_devices, make_mesh
from .sharded import (ShardedImageGuidedAttack, _make_runner, _slices, _whole_frames,
                      compute_dtype_of, replicate, resolve_frame_chunk, snap_frame_chunk)


def ensemble_mesh(devices: Optional[Sequence] = None, model: Optional[int] = None) -> Mesh:
    """A ``('model', 'frames')`` mesh over ``devices`` (default: every local
    CUDA device). The model axis defaults to 4, 2 or 1, the widest of them
    that divides the device count."""
    if devices is None:
        devices = local_devices()
    n = len(devices)
    model = model or (4 if n % 4 == 0 else (2 if n % 2 == 0 else 1))
    if model < 1 or n % model:
        raise ValueError(
            f"model axis {model} does not divide the {n} available "
            f"device(s); pick a divisor of the device count")
    return make_mesh(devices, (model, n // model), ("model", "frames"))


def make_ensemble_parallel_runner(
    models: Sequence[ImageModel],
    mesh: Mesh,
    *,
    steps: int,
    step_size: float = 0.005,
    epsilon: float = 16 / 255,
    adaptive: bool = False,
    aens_momentum: float = 0.0,
    coef_ce: bool = False,
    frame_chunk: int | str | None = None,
    return_modifier: bool = False,
    graphs: bool = True,
):
    """``runner(clean01 (B,C,T,H,W) in [0,1], n_real=None, mod_init=None)
    -> (adv01 clips, per-step costs)`` with the surrogates split over the
    mesh's ``model`` axis (group g = ``models[g·per:(g+1)·per]``) and the
    B·T frame batch over its ``frames`` axis.

    - ``mod_init`` warm-starts Adam from a modifier in the (B·T, 3, H, W)
      frame layout; ``return_modifier`` appends the final, unclipped one:
      the multigrid handoff, as the sharded runner's.
    - ``n_real`` marks the trailing clips of a padded batch as pad: zero
      cost, zero gradient, no share in AENS's coefficient signal.
    - ``frame_chunk`` chunks each position's own slice (``"auto"`` resolved
      for one device, ``i2v_tpu/parallel/ensemble.py:156-170``): at the
      reference's scale the VGG group would otherwise hold the activations
      of its whole slice.
    - ``adaptive=True`` runs AENS (TPAMI_attack.py:255-320).
    - ``graphs`` (default): on a card each position's step, and each
      slice's Adam update, is a CUDA graph captured at the second step of
      the first call of a batch layout and replayed from then on
      (``sharded._Loop``, one a layout in ``runner.loops``); ``graphs=False``
      runs the same steps eagerly.

    ``runner.value_and_grad(clean01, modifier, n_real=None)`` gives the
    first step's cost and gradient without a step; ``runner.coefficients()``
    the AENS coefficients the last call left."""
    if isinstance(frame_chunk, str) and frame_chunk != "auto":
        raise ValueError(f"frame_chunk must be an int, None, or 'auto'; got {frame_chunk!r}")
    m_size, cols = mesh.shape["model"], mesh.shape["frames"]
    models = list(models)
    if len(models) % m_size:
        raise ValueError(f"{len(models)} models do not split over model axis {m_size}")
    per = len(models) // m_size
    groups = [models[g * per:(g + 1) * per] for g in range(m_size)]
    # each group's slice of the coefficient vector, in model order (the
    # layout of attacks/i2v.AENS_I2V_MF and of the sharded runner)
    counts = [sum(len(m.tap_keys) for m in grp) for grp in groups]
    offsets = [sum(counts[:g]) for g in range(m_size)]
    taps = [slice(o, o + c) for o, c in zip(offsets, counts)]
    compute_dtype = compute_dtype_of(models)
    devices = [list(row) for row in mesh.devices]      # (model, frames)
    home = devices[0][0]
    replicas: dict = {}
    placed = [[replicas.setdefault((g, d), replicate(groups[g], d)) for d in row]
              for g, row in enumerate(devices)]

    def frame_slices(clean01):
        """→ (B, T, frame slice f for each f, on position (0, 0)'s device)."""
        b, t, frames = _whole_frames(clean01, home, cols, f"the frames axis of {cols}")
        return b, t, _slices(frames, cols)

    return _make_runner(
        frame_slices,
        lambda n, hw: snap_frame_chunk(resolve_frame_chunk(frame_chunk, n, hw, compute_dtype), n),
        devices, placed, taps, steps=steps, step_size=step_size, epsilon=epsilon,
        adaptive=adaptive, aens_momentum=aens_momentum, coef_ce=coef_ce, remat=False,
        mu_dtype=None, return_modifier=return_modifier, opt_state_io=False, graphs=graphs)


class EnsembleParallelAttack(ShardedImageGuidedAttack):
    """The model-axis runner behind the attack classes' calling convention
    (``image_main --model_parallel N``), for ENS-I2V (image_attacks.py:
    372-376) and, with ``adaptive=True``, AENS-I2V-MF (TPAMI_attack.py:
    255-320). A trailing batch whose B·T does not divide over the frames
    axis is padded with repeats of its last clip, masked inert and sliced
    off. ``multigrid > 0`` runs the coarse-to-fine schedule with this
    runner in both phases (ENS only, as in the JAX package)."""

    _factory = staticmethod(make_ensemble_parallel_runner)

    def __init__(self, models: Sequence[ImageModel], mesh: Mesh, *, steps: int,
                 step_size: float = 0.005, adaptive: bool = False, aens_momentum: float = 0.0,
                 coef_ce: bool = False, frame_chunk: int | str | None = None,
                 name: str = "EnsembleParallelENS", multigrid: int = 0,
                 multigrid_scale: int = 2, graphs: bool = True):
        super().__init__(models, mesh, steps=steps, step_size=step_size, adaptive=adaptive,
                         aens_momentum=aens_momentum, coef_ce=coef_ce, name=name,
                         frame_chunk=frame_chunk, multigrid=multigrid,
                         multigrid_scale=multigrid_scale, graphs=graphs)
