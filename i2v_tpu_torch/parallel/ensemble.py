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
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from ..attacks.core import Attack
from ..models.api import ImageModel
from ..ops import pixel
from .mesh import Mesh, local_devices, make_mesh, move
from .sharded import (_acc, _cat, _load, _Loop, _position, _position_grad, _slices,
                      compute_dtype_of, frame_mask, pad_to_mesh, replicate, resolve_frame_chunk,
                      snap_frame_chunk)


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
    n_taps = sum(counts)
    compute_dtype = compute_dtype_of(models)
    grid = mesh.devices                      # (model, frames)
    home = grid[0, 0]
    homes = [grid[0, f] for f in range(cols)]
    replicas: dict = {}
    for g in range(m_size):
        for f in range(cols):
            replicas.setdefault((g, grid[g, f]), replicate(groups[g], grid[g, f]))
    grad_of = functools.partial(_position_grad, epsilon=epsilon, adaptive=adaptive,
                                coef_ce=coef_ce, n_taps=n_taps, remat=False)
    coeffs_box = [torch.ones(n_taps, dtype=torch.float32, device=home)]

    def frame_slices(clean01, n_real):
        """→ (B, frame slice f for each f (on the home device), the pad
        mask's slices or Nones)."""
        clean01 = torch.as_tensor(clean01).to(home, torch.float32)
        b, _, t = clean01.shape[:3]
        frames = pixel.flatten_clip_to_frames(clean01)
        del clean01
        if (b * t) % cols:
            raise ValueError(f"{b * t} frames do not divide over the frames axis of {cols}")
        mask = frame_mask(b, t, n_real, home)
        return b, _slices(frames, cols), [None] * cols if mask is None else _slices(mask, cols)

    def positions_of(slices, masks) -> list:
        """The positions as a (model, frames) list of lists."""
        n_local = slices[0].shape[0]
        chunk = snap_frame_chunk(resolve_frame_chunk(frame_chunk, n_local, slices[0].shape[2:],
                                                     compute_dtype), n_local)
        return [[_position(replicas[g, grid[g, f]], move(slices[f], grid[g, f]), chunk,
                           None if masks[f] is None else move(masks[f], grid[g, f]), taps[g])
                 for f in range(cols)] for g in range(m_size)]

    # the loops by batch layout, as the JAX runner's jit caches by shape
    loops: dict = {}

    def loop_for(clean01, n_real) -> tuple[int, _Loop]:
        b, slices, masks = frame_slices(clean01, n_real)
        key = (tuple(slices[0].shape), masks[0] is None)
        loop = loops.get(key)
        if loop is None:
            loop = loops[key] = _Loop(
                positions_of(slices, masks), home, steps=steps, step_size=step_size,
                mu_dtype=None, adaptive=adaptive, aens_momentum=aens_momentum, n_taps=n_taps,
                grad_of=grad_of, graphs=graphs)
        else:
            for q, pos in enumerate(loop.positions):
                _load(pos, slices[q % cols], masks[q % cols])
        return b, loop

    def runner(clean01, n_real=None, mod_init=None):
        b, loop = loop_for(clean01, n_real)
        loop.reset(None if mod_init is None else _slices(mod_init, cols), None, coeffs_box[0])
        for _ in range(steps):
            loop.step()
        if adaptive:
            coeffs_box[0] = loop.coeffs.clone()
        out = (pixel.unflatten_frames_to_clip(loop.adversarial(epsilon), b), loop.costs.clone())
        if return_modifier:
            out = out + (_cat([m.clone() for m in loop.modifiers], home),)
        return out

    def value_and_grad(clean01, modifier, n_real=None):
        """The first step's cost and gradient, eagerly: each position's, the
        gradients summed over the model axis on each slice's home, the cost
        over every position on (0, 0)'s device, in position order."""
        _, slices, masks = frame_slices(clean01, n_real)
        positions = positions_of(slices, masks)
        coeffs = None
        if adaptive:
            ones = torch.ones(n_taps, dtype=torch.float32, device=home)
            coeffs = torch.softmax(torch.softmax(ones, dim=0) + aens_momentum * coeffs_box[0],
                                   dim=0)
        mods = _slices(modifier, cols)
        cost, grads = None, [None] * cols
        for g in range(m_size):
            for f in range(cols):
                pos = positions[g][f]
                c, _, gr = grad_of(pos, mods[f].to(pos.frames),
                                   None if coeffs is None else move(coeffs, pos.device))
                cost = _acc(cost, c, home)
                grads[f] = _acc(grads[f], gr, homes[f])
        return cost, _cat(grads, home)

    runner.value_and_grad = value_and_grad
    runner.coefficients = lambda: coeffs_box[0]
    runner.loops = loops
    return runner


class EnsembleParallelAttack(Attack):
    """The model-axis runner behind the attack classes' calling convention
    (``image_main --model_parallel N``), for ENS-I2V (image_attacks.py:
    372-376) and, with ``adaptive=True``, AENS-I2V-MF (TPAMI_attack.py:
    255-320). A trailing batch whose B·T does not divide over the frames
    axis is padded with repeats of its last clip, masked inert and sliced
    off. ``multigrid > 0`` runs the coarse-to-fine schedule with this
    runner in both phases (ENS only, as in the JAX package)."""

    def __init__(self, models: Sequence[ImageModel], mesh: Mesh, *, steps: int,
                 step_size: float = 0.005, adaptive: bool = False, aens_momentum: float = 0.0,
                 coef_ce: bool = False, frame_chunk: int | str | None = None,
                 name: str = "EnsembleParallelENS", multigrid: int = 0,
                 multigrid_scale: int = 2, graphs: bool = True):
        super().__init__(name, None, device=mesh.devices[0, 0])
        self.steps = steps
        self.mesh = mesh
        if multigrid:
            if adaptive:
                raise ValueError("--multigrid does not compose with the adaptive AENS "
                                 "coefficients (their per-tap signal is resolution-coupled)")
            from .multigrid import make_multigrid_i2v_runner

            self._runner = make_multigrid_i2v_runner(
                models, mesh, steps=steps, coarse_steps=multigrid, scale=multigrid_scale,
                step_size=step_size, frame_chunk=frame_chunk,
                runner_factory=functools.partial(make_ensemble_parallel_runner, graphs=graphs))
        else:
            self._runner = make_ensemble_parallel_runner(
                models, mesh, steps=steps, step_size=step_size, adaptive=adaptive,
                aens_momentum=aens_momentum, coef_ce=coef_ce, frame_chunk=frame_chunk,
                graphs=graphs)

    def __call__(self, videos, labels=None, video_names=None) -> torch.Tensor:
        t_axis = 1 if pixel.is_u8_clips(videos) else 2
        videos, pad = pad_to_mesh(videos, 1, self.mesh.shape["frames"], t_axis)
        clean01 = self._clean01(videos)
        del videos
        b = clean01.shape[0] - pad
        adv01, costs = self._runner(clean01, n_real=b if pad else None)
        self._record_costs(costs, video_names)
        return pixel.normalize(adv01[:b] if pad else adv01, channel_axis=1)
