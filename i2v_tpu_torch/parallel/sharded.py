"""Frame-chunked I2V / ENS-I2V / AENS-I2V-MF Adam runner on one device.

PyTorch counterpart of :mod:`i2v_tpu.parallel.sharded` without the mesh
(``i2v_tpu/parallel/sharded.py:64-446``). The I2V and AENS objectives are
sums of per-frame terms: every frame's cosine depends only on that frame's
modifier slice. So the (B·T) frame batch can be cut into chunks whose
gradients are taken one after another and written side by side, which gives
the full batch's cost and gradient while only one chunk's surrogate
activations are alive. That is what lets AENS-I2V-MF run at the reference's
B=16 on one 80 GB card.

Each chunk is a leaf of its own (``modifier.detach()[i:j]``), differentiated
with ``torch.autograd.grad`` into a preallocated gradient buffer: a backward
through a slice of one big modifier would build a zero tensor of the whole
batch for every chunk. Every chunk rebuilds its frames through the
hand-written kernel pair (:func:`i2v_tpu_torch.ops.kernels.rebuild_adv`), so
a step launches K1 and K2 once a chunk, and the final rebuild K1 once over
the whole batch.

The surrogates compute in their own dtype (``get_image_models(...,
dtype=torch.bfloat16)``); the frames, the modifier, the kernels' rebuild and
the gradient stay float32, and the cast to bfloat16 happens inside each
surrogate, after its normalization. ``mu_dtype`` keeps Adam's first moment
in a narrower dtype, as the JAX runner's optax ``scale_by_adam`` does.

The JAX runner's ``unroll``, ``chunk_unroll`` and ``donate`` steer XLA's
scheduling and buffers, and ``runner.jitted``/``example_args`` are hooks for
ahead-of-time lowering; none has a meaning here (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.nn.utils import parametrize
from torch.utils.checkpoint import checkpoint

from ..attacks.core import Attack
from ..attacks.i2v import MODIFIER_INIT, _collect_taps
from ..models.api import ImageModel
from ..ops import kernels, losses, pixel

# The byte budget of ``frame_chunk="auto"``: one chunk's input frames in the
# surrogates' compute dtype, whose activations scale with it (float32: 256
# frames at 224²; bfloat16: 512, so B=16 x 32 frames runs whole). The JAX
# package sized its budget on a 16 GB TPU chip (float32 at 224² resolved to
# 128 frames there); that measurement does not carry over.
# Here it is 256 frames at 224², the fastest chunk of the sweep of
# ``tools/torch_eval_profile.py --attacks --frame_chunk 64,128,256,none`` at
# B=16 on an H100 80GB HBM3 at 700 W (PERF.md §5): AENS-I2V-MF with TF32 off
# took 0.603, 0.675 and 0.697 steps/s at 64, 128 and 256 frames (peaks
# 16.58, 25.66 and 44.87 GiB; whole, it runs out of memory), and 256 was
# also the fastest with TF32 convs and for ENS-I2V.
AUTO_CHUNK_BYTES = 256 * 4 * 224 * 224


def resolve_frame_chunk(frame_chunk, n_frames: int, hw,
                        compute_dtype: torch.dtype = torch.float32) -> Optional[int]:
    """Resolve a ``frame_chunk`` setting against the frame batch's shape.

    ``int`` and ``None`` pass through untouched; ``"auto"`` gives the chunk
    of ``AUTO_CHUNK_BYTES`` of frames at ``hw`` in the surrogates' compute
    dtype (``i2v_tpu/parallel/sharded.py:36-55``; their storage dtype does
    not count), or ``None`` (unchunked) when the whole batch fits that
    budget. The runner then snaps a chunk that does not divide the batch
    (:func:`snap_frame_chunk`)."""
    if frame_chunk != "auto":
        if isinstance(frame_chunk, str):
            raise ValueError(f"frame_chunk must be an int, None, or 'auto'; got {frame_chunk!r}")
        return frame_chunk
    h, w = int(hw[0]), int(hw[1])
    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    target = max(1, AUTO_CHUNK_BYTES // (itemsize * h * w))
    return None if n_frames <= target else target


def compute_dtype_of(models: Sequence[ImageModel]) -> torch.dtype:
    """The ensemble's activation dtype, on which the chunk budget is spent:
    the widest compute dtype of its surrogates (a float32/bfloat16 mix
    budgets as float32), as the JAX runner's ``_compute_dtype``."""
    out = models[0].dtype
    for m in models[1:]:
        out = torch.promote_types(out, m.dtype)
    return out


def snap_frame_chunk(chunk: Optional[int], n_frames: int) -> int:
    """The chunk the runner takes: the whole batch when ``chunk`` is None or
    not below it, else the largest divisor of ``n_frames`` that fits
    ``chunk``, so that a trailing partial batch keeps the accumulation exact
    (``i2v_tpu/parallel/sharded.py:172-179``)."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"frame_chunk must be at least 1, got {chunk}")
    if chunk is None or chunk >= n_frames:
        return n_frames
    return max(d for d in range(1, chunk + 1) if n_frames % d == 0)


class _StoredAs(nn.Module):
    """Parametrization: the tensor is stored in ``storage_dtype`` and read
    in ``read_dtype``, the module's compute dtype: a float32 conv runs on
    the rounded weights, a bfloat16 one reads them as they are stored."""

    def __init__(self, storage_dtype: torch.dtype, read_dtype: torch.dtype):
        super().__init__()
        self.storage_dtype = storage_dtype
        self.read_dtype = read_dtype

    def forward(self, stored: torch.Tensor) -> torch.Tensor:
        return stored.to(self.read_dtype)

    def right_inverse(self, weight: torch.Tensor):
        # a one-tensor sequence may change the dtype; a bare tensor may not
        return (weight.to(self.storage_dtype),)


def cast_param_storage(models: Sequence[ImageModel], dtype: torch.dtype) -> list[ImageModel]:
    """Copies of ``models`` whose floating parameters (the BN-folded conv
    weights and biases, the tensors the JAX package rounds) are stored in
    ``dtype`` and read into each surrogate's compute dtype at each forward:
    the JAX runner's ``param_dtype``, whose Flax modules cast the stored
    parameters to their compute dtype (a float32 surrogate computes on
    bf16-rounded weights; a bfloat16 one holds no float32 copy). The
    callers' modules are left as they are."""
    out = []
    for m in models:
        module = copy.deepcopy(m.module)
        for sub in list(module.modules()):
            for name, p in list(sub.named_parameters(recurse=False)):
                if p.is_floating_point():
                    parametrize.register_parametrization(sub, name, _StoredAs(dtype, m.dtype))
        out.append(dataclasses.replace(m, module=module))
    return out


def frame_mask(b: int, t: int, n_real: Optional[int], device) -> Optional[torch.Tensor]:
    """None (a full batch), or the (B·T,) clip-major prefix mask of n_real·T
    ones that keeps the trailing pad clips out of the cost, the gradients and
    AENS's coefficient sums (``i2v_tpu/parallel/sharded.py:336-344``)."""
    if n_real is None or n_real >= b:
        return None
    return (torch.arange(b * t, device=device) < n_real * t).float()


@dataclasses.dataclass
class _Batch:
    """One runner call's frames, chunk bounds, mask and clean taps, and the
    buffer the chunks' gradients are written into (None for one chunk)."""

    clips: int
    frames: torch.Tensor
    bounds: list
    fmask: Optional[torch.Tensor]
    clean_taps: list
    grad_buf: Optional[torch.Tensor]


def _adam(modifier: torch.Tensor, step_size: float, opt_init) -> torch.optim.Adam:
    """``torch.optim.Adam`` as ``attacks/i2v.py`` builds it; ``opt_init =
    (step, exp_avg, exp_avg_sq)`` resumes a saved state."""
    opt = torch.optim.Adam([modifier], lr=step_size, betas=(0.9, 0.999), eps=1e-8,
                           foreach=False, fused=False)
    if opt_init is not None:
        step, exp_avg, exp_avg_sq = opt_init
        opt.state[modifier] = {
            # torch keeps a non-capturable step as a float32 scalar on the CPU
            "step": torch.as_tensor(step, dtype=torch.float32).detach().cpu().clone(),
            "exp_avg": exp_avg.detach().to(modifier).clone(),
            "exp_avg_sq": exp_avg_sq.detach().to(modifier).clone(),
        }
    return opt


def _adam_state(opt: torch.optim.Adam, param: torch.Tensor):
    """``(step, exp_avg, exp_avg_sq)`` of ``param``, zeros before a step."""
    st = opt.state[param]
    if not st:
        zeros = torch.zeros_like(param.detach())
        return torch.tensor(0.0), zeros, zeros.clone()
    return st["step"].clone(), st["exp_avg"].clone(), st["exp_avg_sq"].clone()


class _AdamMu:
    """``optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8, mu_dtype=...)``, the JAX
    runner's optimizer when ``mu_dtype`` is set (optax's ``scale_by_adam``,
    which ``torch.optim.Adam`` does not match: the bias corrections divide
    the moments, and ε is added after the square root of the corrected
    second moment). Each step:

      mu = (1 − b1)·g + b1·mu_stored    (b1·mu_stored is taken in mu_dtype,
                                         b1 rounded to it too: JAX casts the
                                         weakly typed Python float to the
                                         array's dtype)
      nu = (1 − b2)·g² + b2·nu           float32
      modifier += −lr · (mu / (1 − b1ᵗ)) / (√(nu / (1 − b2ᵗ)) + ε)

    from the float32 ``mu``; only then is ``mu`` rounded to ``mu_dtype`` to
    be stored. ``opt_init = (count, mu, nu)`` resumes a saved state."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, param: torch.Tensor, lr: float, mu_dtype: torch.dtype, opt_init):
        self.param, self.lr = param, lr
        if opt_init is None:
            self.count = 0
            self.mu = torch.zeros_like(param.detach(), dtype=mu_dtype)
            self.nu = torch.zeros_like(param.detach())
        else:
            count, mu, nu = opt_init
            self.count = int(torch.as_tensor(count))
            self.mu = mu.detach().to(param.device, mu_dtype).clone()
            self.nu = nu.detach().to(param).clone()

    @torch.no_grad()
    def step(self) -> None:
        g = self.param.grad
        self.count += 1
        b1 = torch.tensor(self.B1, dtype=self.mu.dtype, device=self.mu.device)
        mu = (1 - self.B1) * g + (b1 * self.mu).float()
        self.nu = (1 - self.B2) * (g * g) + self.B2 * self.nu
        # optax takes decay**count in float32
        bc1 = float(np.float32(1) - np.float32(self.B1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(self.B2) ** np.float32(self.count))
        update = (mu / bc1) / (torch.sqrt(self.nu / bc2) + self.EPS)
        self.param.add_(update * -self.lr)
        self.mu = mu.to(self.mu.dtype)

    def io_state(self):
        """``(count, mu, nu)``: the count as a float32 scalar, as
        :func:`_adam_state` gives torch Adam's step, and ``mu`` in
        ``mu_dtype``."""
        return (torch.tensor(float(self.count)), self.mu.clone(), self.nu.clone())


def make_sharded_i2v_runner(
    models: Sequence[ImageModel],
    *,
    steps: int,
    step_size: float = 0.005,
    epsilon: float = 16 / 255,
    adaptive: bool = False,
    aens_momentum: float = 0.0,
    coef_ce: bool = False,
    remat: bool = False,
    frame_chunk: int | str | None = None,
    param_dtype: Optional[torch.dtype] = None,
    return_modifier: bool = False,
    opt_state_io: bool = False,
    mu_dtype=None,
    device: torch.device | str | None = None,
):
    """Build an I2V / ENS-I2V (``adaptive=False``) or AENS-I2V-MF runner.

    ``runner(clean01 (B,C,T,H,W) in [0,1], n_real=None, mod_init=None,
    opt_init=None) -> (adv01 clips, per-step costs)`` on ``device`` (default:
    the surrogates' device).

    - ``frame_chunk``: accumulate the gradient over chunks of this many
      frames (``"auto"``: :func:`resolve_frame_chunk`); the clean taps are
      collected chunk by chunk too. Costs and gradients are the full batch's.
    - ``mod_init`` warm-starts from a caller-built modifier in the
      (B·T, 3, H, W) frame layout instead of the 0.01/255 fill;
      ``return_modifier`` appends the final, unclipped modifier.
    - ``opt_state_io`` takes ``opt_init = (step, exp_avg, exp_avg_sq)``,
      torch Adam's state (the JAX runner's ``(count, mu, nu)``; see
      :mod:`i2v_tpu_torch.models.convert`), and appends the final one:
      chained segments equal one run of all their steps, bit for bit.
    - ``n_real`` marks the trailing clips of a padded batch as pad.
    - AENS's coefficients persist across runner calls, as the reference's
      instance state does; the previous per-tap loss resets on each call.
    - ``param_dtype=torch.bfloat16`` stores the surrogates' weights in bf16
      (:func:`cast_param_storage`); each surrogate computes in its own
      dtype (``get_image_models(..., dtype=)``), which also sizes the
      ``"auto"`` chunk (:func:`compute_dtype_of`).
    - ``remat`` recomputes the surrogates' forward in the backward
      (``torch.utils.checkpoint``), holding only the taps.
    - ``mu_dtype=torch.bfloat16`` stores Adam's first moment in bf16 and
      steps as the JAX runner's optax Adam does (:class:`_AdamMu`), not as
      ``torch.optim.Adam``; ``opt_init``/``opt_state_io`` then carry
      ``(count, mu, nu)`` with ``mu`` in ``mu_dtype``.

    ``runner.value_and_grad(clean01, modifier, n_real=None)`` gives the
    first step's cost and its gradient w.r.t. ``modifier``, chunked as the
    runner chunks, without a step."""
    if mu_dtype is not None and not (isinstance(mu_dtype, torch.dtype)
                                     and mu_dtype.is_floating_point):
        raise ValueError(f"mu_dtype must be a floating torch dtype, got {mu_dtype!r}")
    if isinstance(frame_chunk, str) and frame_chunk != "auto":
        raise ValueError(f"frame_chunk must be an int, None, or 'auto'; got {frame_chunk!r}")
    models = list(models)
    if param_dtype is not None:
        models = cast_param_storage(models, param_dtype)
    device = torch.device(device) if device is not None else models[0].device
    n_taps = sum(len(m.tap_keys) for m in models)
    compute_dtype = compute_dtype_of(models)

    def collect(frames01):
        return _collect_taps(models, frames01)

    def collect_grad(frames01):
        if remat:
            return checkpoint(collect, frames01, use_reentrant=False)
        return collect(frames01)

    # AENS's coefficients persist across calls (TPAMI_attack.py:165,265)
    coeffs_box = [torch.ones(n_taps, dtype=torch.float32, device=device)]

    def state0():
        if not adaptive:
            return None
        return coeffs_box[0], torch.ones(n_taps, dtype=torch.float32, device=device)

    def prepare(clean01, n_real) -> _Batch:
        clean01 = torch.as_tensor(clean01).to(device, torch.float32)
        b, _, t = clean01.shape[:3]
        frames = pixel.flatten_clip_to_frames(clean01)
        del clean01
        n = frames.shape[0]
        chunk = snap_frame_chunk(
            resolve_frame_chunk(frame_chunk, n, frames.shape[2:], compute_dtype), n)
        bounds = [(i, i + chunk) for i in range(0, n, chunk)]
        with torch.no_grad():
            # chunk by chunk: a full-batch clean forward would set the very
            # peak that chunking avoids
            clean_taps = [collect(frames[i:j]) for i, j in bounds]
        grad_buf = torch.empty_like(frames) if len(bounds) > 1 else None
        return _Batch(b, frames, bounds, frame_mask(b, t, n_real, device), clean_taps, grad_buf)

    def grad_and_state(batch: _Batch, modifier, state):
        """→ (cost, gradient, next state) of one step at ``modifier``."""
        coeffs = None
        if adaptive:
            coeffs_prev, prev = state
            coeffs = torch.softmax(torch.softmax(prev, dim=0) + aens_momentum * coeffs_prev, dim=0)
        cost = signal = grad = None
        for (i, j), ct in zip(batch.bounds, batch.clean_taps):
            m_c = modifier.detach()[i:j].requires_grad_(True)
            fm = None if batch.fmask is None else batch.fmask[i:j]
            with torch.enable_grad():
                taps = collect_grad(kernels.rebuild_adv(batch.frames[i:j], m_c, epsilon))
                if adaptive:
                    per_tap = losses.per_tap_frame_cosines(taps, ct)      # (taps, chunk)
                    if fm is not None:
                        per_tap = per_tap * fm[None, :]
                    each = torch.sum(coeffs[:, None] * per_tap, dim=1)
                    c = torch.mean(each)
                    # coef_CE picks the weighted per-tap loss as the next
                    # coefficient signal (TPAMI_attack.py:293-297)
                    s = (each if coef_ce else torch.sum(per_tap, dim=1)).detach()
                    signal = s if signal is None else signal + s
                else:
                    c = losses.i2v_cost(taps, ct, frame_weights=fm)
            (g,) = torch.autograd.grad(c, m_c)
            if batch.grad_buf is None:
                grad = g
            else:
                batch.grad_buf[i:j].copy_(g)
                grad = batch.grad_buf
            cost = c.detach() if cost is None else cost + c.detach()
        return cost, grad, ((coeffs, signal) if adaptive else state)

    def runner(clean01, n_real=None, mod_init=None, opt_init=None):
        batch = prepare(clean01, n_real)
        frames = batch.frames
        modifier = (torch.full_like(frames, MODIFIER_INIT) if mod_init is None
                    else torch.as_tensor(mod_init).to(frames).clone()).requires_grad_(True)
        opt = (_adam(modifier, step_size, opt_init) if mu_dtype is None
               else _AdamMu(modifier, step_size, mu_dtype, opt_init))
        state, costs = state0(), []
        for _ in range(steps):
            cost, grad, state = grad_and_state(batch, modifier, state)
            modifier.grad = grad
            opt.step()
            costs.append(cost)
        if adaptive:
            coeffs_box[0] = state[0]
        final = modifier.detach()
        with torch.no_grad():
            adv = kernels.rebuild_adv(frames, final, epsilon)
        out = (pixel.unflatten_frames_to_clip(adv, batch.clips),
               torch.stack(costs) if costs else frames.new_zeros(0))
        if return_modifier:
            out = out + (final,)
        if opt_state_io:
            out = out + (_adam_state(opt, modifier) if mu_dtype is None else opt.io_state(),)
        return out

    def value_and_grad(clean01, modifier, n_real=None):
        batch = prepare(clean01, n_real)
        modifier = torch.as_tensor(modifier).to(batch.frames)
        cost, grad, _ = grad_and_state(batch, modifier, state0())
        return cost, grad

    runner.value_and_grad = value_and_grad
    return runner


class ShardedImageGuidedAttack(Attack):
    """The runner behind the attack classes' calling convention
    (``attack(videos, labels, video_names) -> normalized adversarial
    clips``), for ``image_main --sharded``: per-step costs go into
    ``loss_info``. With ``multigrid > 0`` it runs the coarse-to-fine
    schedule (:mod:`.multigrid`). One device holds the whole batch, so the
    JAX adapter's pad-to-the-mesh step has nothing to do here."""

    def __init__(self, models: Sequence[ImageModel], *, steps: int, step_size: float,
                 adaptive: bool = False, aens_momentum: float = 0.0, coef_ce: bool = False,
                 name: str = "ShardedI2V", frame_chunk: int | str | None = None,
                 param_dtype: Optional[torch.dtype] = None, multigrid: int = 0,
                 multigrid_scale: int = 2):
        models = list(models)
        super().__init__(name, None, device=models[0].device)
        self.steps = steps
        if multigrid:
            if adaptive:
                raise ValueError("--multigrid does not compose with the adaptive AENS "
                                 "coefficients (their per-tap signal is resolution-coupled)")
            from .multigrid import make_multigrid_i2v_runner

            self._runner = make_multigrid_i2v_runner(
                models, steps=steps, coarse_steps=multigrid, scale=multigrid_scale,
                step_size=step_size, frame_chunk=frame_chunk, param_dtype=param_dtype)
        else:
            self._runner = make_sharded_i2v_runner(
                models, steps=steps, step_size=step_size, adaptive=adaptive,
                aens_momentum=aens_momentum, coef_ce=coef_ce, frame_chunk=frame_chunk,
                param_dtype=param_dtype)

    def __call__(self, videos, labels=None, video_names=None) -> torch.Tensor:
        # the normalized clips are not kept: the runner's flattened frames
        # replace them on the device
        adv01, costs = self._runner(self._clean01(videos))
        self._record_costs(costs, video_names)
        return pixel.normalize(adv01, channel_axis=1)
