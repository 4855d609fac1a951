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
(0, 0)'s device, in position order.

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
from ..attacks.i2v import MODIFIER_INIT
from ..models.api import ImageModel
from ..ops import kernels, pixel
from .mesh import Mesh, local_devices, make_mesh, move
from .sharded import (_acc, _adam, _cat, _position, _position_grad, _slices, compute_dtype_of,
                      frame_mask, pad_to_mesh, replicate, resolve_frame_chunk, snap_frame_chunk)


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

    def state0():
        if not adaptive:
            return None
        return coeffs_box[0], torch.ones(n_taps, dtype=torch.float32, device=home)

    def prepare(clean01, n_real):
        """→ (B, frame slice f on its home device for each f, positions as
        a (model, frames) list of lists)."""
        clean01 = torch.as_tensor(clean01).to(home, torch.float32)
        b, _, t = clean01.shape[:3]
        frames = pixel.flatten_clip_to_frames(clean01)
        del clean01
        if (b * t) % cols:
            raise ValueError(f"{b * t} frames do not divide over the frames axis of {cols}")
        n_local = b * t // cols
        chunk = snap_frame_chunk(resolve_frame_chunk(frame_chunk, n_local, frames.shape[2:],
                                                     compute_dtype), n_local)
        slices = _slices(frames, cols)
        mask = frame_mask(b, t, n_real, home)
        masks = [None] * cols if mask is None else _slices(mask, cols)
        positions = [[_position(replicas[g, grid[g, f]], move(slices[f], grid[g, f]), chunk,
                                None if masks[f] is None else move(masks[f], grid[g, f]),
                                taps[g])
                      for f in range(cols)] for g in range(m_size)]
        return b, [move(s, d) for s, d in zip(slices, homes)], positions

    def grad_and_state(positions, modifiers, state):
        """→ (cost, each slice's gradient on its home device, next state)."""
        coeffs = None
        if adaptive:
            coeffs_prev, prev = state
            coeffs = torch.softmax(torch.softmax(prev, dim=0) + aens_momentum * coeffs_prev, dim=0)
        # every copy the step needs is queued before any position's work: a
        # copy out of a card runs on its stream, behind the work queued there,
        # and the card it goes to would wait for that work
        mods = [[move(modifiers[f].detach(), positions[g][f].device) for f in range(cols)]
                for g in range(m_size)]
        devices = dict.fromkeys(q.device for row in positions for q in row)
        coeffs_on = {} if coeffs is None else {d: move(coeffs, d) for d in devices}
        cost, grads, signals = None, [None] * cols, [None] * m_size
        for g in range(m_size):
            for f in range(cols):
                pos = positions[g][f]
                c, s, gr = grad_of(pos, mods[g][f], coeffs_on.get(pos.device))
                cost = _acc(cost, c, home)
                grads[f] = _acc(grads[f], gr, homes[f])
                signals[g] = _acc(signals[g], s, home)
        if not adaptive:
            return cost, grads, state
        return cost, grads, (coeffs, signals[0] if m_size == 1 else torch.cat(signals))

    def runner(clean01, n_real=None, mod_init=None):
        b, home_frames, positions = prepare(clean01, n_real)
        inits = None if mod_init is None else _slices(mod_init, cols)
        modifiers = [(torch.full_like(fr, MODIFIER_INIT) if inits is None
                      else inits[f].to(fr).clone()).requires_grad_(True)
                     for f, fr in enumerate(home_frames)]
        opt = _adam(modifiers, step_size, None)
        state, costs = state0(), []
        for _ in range(steps):
            cost, grads, state = grad_and_state(positions, modifiers, state)
            for m, gr in zip(modifiers, grads):
                m.grad = gr
            opt.step()
            costs.append(cost)
        if adaptive:
            coeffs_box[0] = state[0]
        finals = [m.detach() for m in modifiers]
        with torch.no_grad():
            adv = _cat([kernels.rebuild_adv(fr, m, epsilon)
                        for fr, m in zip(home_frames, finals)], home)
        out = (pixel.unflatten_frames_to_clip(adv, b),
               torch.stack(costs) if costs else adv.new_zeros(0))
        return out + (_cat(finals, home),) if return_modifier else out

    def value_and_grad(clean01, modifier, n_real=None):
        _, home_frames, positions = prepare(clean01, n_real)
        mods = [m.to(fr) for m, fr in zip(_slices(modifier, cols), home_frames)]
        cost, grads, _ = grad_and_state(positions, mods, state0())
        return cost, _cat(grads, home)

    runner.value_and_grad = value_and_grad
    runner.coefficients = lambda: coeffs_box[0]
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
                 multigrid_scale: int = 2):
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
                runner_factory=make_ensemble_parallel_runner)
        else:
            self._runner = make_ensemble_parallel_runner(
                models, mesh, steps=steps, step_size=step_size, adaptive=adaptive,
                aens_momentum=aens_momentum, coef_ce=coef_ce, frame_chunk=frame_chunk)

    def __call__(self, videos, labels=None, video_names=None) -> torch.Tensor:
        t_axis = 1 if pixel.is_u8_clips(videos) else 2
        videos, pad = pad_to_mesh(videos, 1, self.mesh.shape["frames"], t_axis)
        clean01 = self._clean01(videos)
        del videos
        b = clean01.shape[0] - pad
        adv01, costs = self._runner(clean01, n_real=b if pad else None)
        self._record_costs(costs, video_names)
        return pixel.normalize(adv01[:b] if pad else adv01, channel_axis=1)
