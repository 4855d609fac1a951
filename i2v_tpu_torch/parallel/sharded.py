"""Frame-chunked I2V / ENS-I2V / AENS-I2V-MF Adam runner, on one device or
over a device mesh.

PyTorch counterpart of :mod:`i2v_tpu.parallel.sharded`
(``i2v_tpu/parallel/sharded.py:64-446``). The I2V and AENS objectives are
sums of per-frame terms: every frame's cosine depends only on that frame's
modifier slice. So the (B·T) frame batch can be cut into chunks whose
gradients are taken one after another and written side by side, which gives
the full batch's cost and gradient while only one chunk's surrogate
activations are alive. That is what lets AENS-I2V-MF run at the reference's
B=16 on one 80 GB card. The same argument cuts the batch over the positions
of a device mesh (:mod:`.mesh`): each position holds a contiguous slice of
the frames, its modifier slice and its slice of Adam's state (Adam is
elementwise), and only the scalar cost and AENS's per-tap signal are summed
across positions, on the first position's device, in position order.

Each chunk is a leaf of its own (``modifier.detach()[i:j]``), differentiated
with ``torch.autograd.grad`` into a preallocated gradient buffer: a backward
through a slice of one big modifier would build a zero tensor of the whole
batch for every chunk. Every chunk rebuilds its frames through the
hand-written kernel pair (:func:`i2v_tpu_torch.ops.kernels.rebuild_adv`), so
a step launches K1 and K2 once a chunk of each position, and the final
rebuild K1 once a position.

The surrogates compute in their own dtype (``get_image_models(...,
dtype=torch.bfloat16)``); the frames, the modifier, the kernels' rebuild and
the gradient stay float32, and the cast to bfloat16 happens inside each
surrogate, after its normalization. ``mu_dtype`` keeps Adam's first moment
in a narrower dtype, as the JAX runner's optax ``scale_by_adam`` does.

The JAX runner is one ``jit`` a batch shape, its buffers donated
(``runner.jitted``, ``example_args``, ``donate``). Here a runner keeps one
:class:`_Loop` a batch layout: static buffers that a second batch of the
same layout is copied into, and each step captured once as a CUDA graph
and replayed (:mod:`i2v_tpu_torch.utils.graphs`). Adam reads its per-step
scalars from a device table (:class:`~i2v_tpu_torch.utils.graphs.TableAdam`),
so no step waits on the host. ``unroll`` and ``chunk_unroll``, XLA's
scheduling of the scan, have no counterpart: a graph replays one step.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
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
from ..utils.graphs import StepGraph, TableAdam
from ..utils.profiling import next_number, span
from .mesh import Mesh, Sharded, move

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
                        compute_dtype: torch.dtype = torch.float32,
                        n_devices: int = 1) -> Optional[int]:
    """Resolve a ``frame_chunk`` setting against the frame batch's shape.

    ``int`` and ``None`` pass through untouched; ``"auto"`` gives the chunk
    of ``AUTO_CHUNK_BYTES`` of frames at ``hw`` in the surrogates' compute
    dtype a device (``i2v_tpu/parallel/sharded.py:36-55``; their storage
    dtype does not count), times ``n_devices`` when the chunk is cut over a
    mesh, or ``None`` (unchunked) when the whole batch fits that budget.
    The runner then snaps a chunk that does not divide the batch
    (:func:`snap_frame_chunk`)."""
    if frame_chunk != "auto":
        if isinstance(frame_chunk, str):
            raise ValueError(f"frame_chunk must be an int, None, or 'auto'; got {frame_chunk!r}")
        return frame_chunk
    h, w = int(hw[0]), int(hw[1])
    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    target = max(1, AUTO_CHUNK_BYTES // (itemsize * h * w)) * n_devices
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


def replicate(models: Sequence[ImageModel], device) -> list[ImageModel]:
    """``models`` on ``device``: the bundles themselves where they are there
    already, else deep copies moved there. A runner makes one replica a
    distinct device of its mesh, so a device that fills several positions
    holds one copy of the weights."""
    device = torch.device(device)
    if all(m.device == device for m in models):
        return list(models)
    return [dataclasses.replace(m, module=copy.deepcopy(m.module).to(device)) for m in models]


def _cat(pieces: list, home: torch.device) -> torch.Tensor:
    """Per-position pieces of a frame tensor, whole on ``home``, in order."""
    if len(pieces) == 1:
        return pieces[0]
    return torch.cat([move(p, home) for p in pieces])


def _acc(total, x, home: torch.device):
    """``total + x`` on ``home``, positions added in order (None: nothing yet)."""
    if x is None:
        return total
    x = move(x, home)
    return x if total is None else total + x


@dataclasses.dataclass
class _Position:
    """One mesh position's share of a runner call: its device and models,
    its slice of the frame batch, chunk bounds within the slice, the slice's
    pad mask and clean taps (one list a chunk), the buffer the chunks'
    gradients are written into (None for one chunk), and where its models'
    taps sit in the ensemble's AENS coefficient vector."""

    device: torch.device
    models: list
    frames: torch.Tensor
    bounds: list
    fmask: Optional[torch.Tensor]
    clean_taps: list
    grad_buf: Optional[torch.Tensor]
    taps: slice


def _position(models: list, frames: torch.Tensor, chunk: int, fmask, taps: slice) -> _Position:
    n = frames.shape[0]
    bounds = [(i, i + chunk) for i in range(0, n, chunk)]
    with torch.no_grad():
        # chunk by chunk: a whole-slice clean forward would set the very
        # peak that chunking avoids
        clean_taps = [_collect_taps(models, frames[i:j]) for i, j in bounds]
    grad_buf = torch.empty_like(frames) if len(bounds) > 1 else None
    return _Position(frames.device, models, frames, bounds, fmask, clean_taps, grad_buf, taps)


def _load(pos: _Position, frames: torch.Tensor, fmask) -> None:
    """A new batch of the position's shape into its static buffers: the
    frames, the pad mask and the clean taps, chunk by chunk."""
    pos.frames.copy_(frames)
    if fmask is not None:
        pos.fmask.copy_(fmask)
    with torch.no_grad():
        for (i, j), held in zip(pos.bounds, pos.clean_taps):
            for old, new in zip(held, _collect_taps(pos.models, pos.frames[i:j])):
                old.copy_(new)


def _position_grad(pos: _Position, modifier: torch.Tensor, coeffs, *, epsilon: float,
                   adaptive: bool, coef_ce: bool, n_taps: int, remat: bool):
    """→ (cost, AENS signal or None, gradient) of the position's models over
    its frames at ``modifier``, the position's slice (moved to its device).

    The AENS cost is the mean over all the ensemble's ``n_taps`` taps of
    the coefficient-weighted frame sums; a position that holds a group of
    the surrogates adds its taps' share, ``sum / n_taps``, and its signal
    covers its own taps, ``pos.taps`` of the coefficient vector."""
    modifier = move(modifier.detach(), pos.device)
    cost = signal = grad = None
    for (i, j), ct in zip(pos.bounds, pos.clean_taps):
        m_c = modifier[i:j].requires_grad_(True)
        fm = None if pos.fmask is None else pos.fmask[i:j]
        with torch.enable_grad():
            adv01 = kernels.rebuild_adv(pos.frames[i:j], m_c, epsilon)
            if remat:
                # nothing random runs in the frozen surrogates, so the RNG
                # state needs no saving (which a CUDA graph capture refuses)
                taps = checkpoint(_collect_taps, pos.models, adv01, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                taps = _collect_taps(pos.models, adv01)
            if adaptive:
                per_tap = losses.per_tap_frame_cosines(taps, ct)      # (taps, chunk)
                if fm is not None:
                    per_tap = per_tap * fm[None, :]
                each = torch.sum(coeffs[pos.taps, None] * per_tap, dim=1)
                c = torch.mean(each) if each.shape[0] == n_taps else torch.sum(each) / n_taps
                # coef_CE picks the weighted per-tap loss as the next
                # coefficient signal (TPAMI_attack.py:293-297)
                s = (each if coef_ce else torch.sum(per_tap, dim=1)).detach()
                signal = s if signal is None else signal + s
            else:
                c = losses.i2v_cost(taps, ct, frame_weights=fm)
        (g,) = torch.autograd.grad(c, m_c)
        if pos.grad_buf is None:
            grad = g
        else:
            pos.grad_buf[i:j].copy_(g)
            grad = pos.grad_buf
        cost = c.detach() if cost is None else cost + c.detach()
    return cost, signal, grad


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
    be stored. ``opt_init = (count, mu, nu)`` resumes a saved state.

    The eager form: the runner steps :class:`~i2v_tpu_torch.utils.graphs.TableAdam`
    with ``mu_dtype``, which equals it bit for bit on the CPU (the tests)."""

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
        # made once: a tensor built from a Python number on a card is a copy
        # that makes the host wait for the card
        self.b1 = torch.tensor(self.B1, dtype=mu_dtype).to(param.device)

    @torch.no_grad()
    def step(self) -> None:
        g = self.param.grad
        self.count += 1
        mu = (1 - self.B1) * g + (self.b1 * self.mu).float()
        self.nu = (1 - self.B2) * (g * g) + self.B2 * self.nu
        # optax takes decay**count in float32
        bc1 = float(np.float32(1) - np.float32(self.B1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(self.B2) ** np.float32(self.count))
        update = (mu / bc1) / (torch.sqrt(self.nu / bc2) + self.EPS)
        self.param.add_(update * -self.lr)
        self.mu = mu.to(self.mu.dtype)

    def io_state(self):
        """``(count, mu, nu)``: the count as a float32 scalar, as
        :meth:`~i2v_tpu_torch.utils.graphs.TableAdam.state` gives torch
        Adam's step, and ``mu`` in ``mu_dtype``."""
        return (torch.tensor(float(self.count)), self.mu.clone(), self.nu.clone())


def _slices(x, n_slices: int) -> list:
    """Dim 0 of ``x`` cut into ``n_slices`` equal contiguous views."""
    x = torch.as_tensor(x)
    per = x.shape[0] // n_slices
    return [x[k * per:(k + 1) * per] for k in range(n_slices)]


def _local_chunk(frame_chunk, n_frames: int, hw, compute_dtype, n_positions: int) -> int:
    """A position's chunk: the batch's chunk (``"auto"`` resolved with the
    per-device budget times the positions, as the JAX runner resolves it
    for a mesh), cut over the positions as the frames are, then snapped to
    divide the position's slice."""
    chunk = resolve_frame_chunk(frame_chunk, n_frames, hw, compute_dtype, n_positions)
    local = None if chunk is None else max(1, chunk // n_positions)
    return snap_frame_chunk(local, n_frames // n_positions)


class _Loop:
    """A runner's static buffers and step graphs for one batch layout.

    ``grid`` holds the positions as rows of columns: one row for this
    module's runner (its positions in mesh order), one row a surrogate group
    for the model-axis runner (:mod:`.ensemble`), where position (g, f) runs
    group g's models over frame slice f. Each position holds its frames,
    clean taps, pad mask and gradient buffer, and its cost and AENS signal
    of the step. Column f's modifier and its Adam state
    (:class:`~i2v_tpu_torch.utils.graphs.TableAdam`) live on row 0's
    position, the column's home. The first position's device holds the
    per-step costs and AENS's coefficients (those of the step under way)
    and previous per-tap loss.

    One position on that device runs the whole step as one graph. Over a
    mesh each position's chunks are a graph on its card, with its column's
    Adam update in it where the grid has one row. With several rows each
    column's Adam is a graph of its own on the column's home, after the
    gradients of the column's positions are summed there over the rows. The
    sums across positions, the coefficient update and the copies between
    cards (the coefficients and, with several rows, each column's modifier,
    to its positions) run between the graphs, in position order (row-major),
    as the eager runners summed them."""

    def __init__(self, grid: list, home: torch.device, *, steps: int, step_size: float,
                 mu_dtype, adaptive: bool, aens_momentum: float, n_taps: int, grad_of,
                 graphs: bool):
        self.grid, self.home = grid, home
        self.positions = [p for row in grid for p in row]
        self.cols = len(grid[0])
        self.adaptive, self.momentum, self.grad_of = adaptive, aens_momentum, grad_of
        self.modifiers = [torch.full_like(p.frames, MODIFIER_INIT) for p in grid[0]]
        self.adams = [TableAdam(m, step_size, steps, mu_dtype) for m in self.modifiers]
        self.costs = torch.zeros(steps, device=home)
        self.k = torch.zeros(1, dtype=torch.long, device=home)
        self.whole = len(self.positions) == 1 and self.positions[0].device == home
        self.summed = len(grid) > 1
        # each position's modifier: its column's, or a copy on its card
        self.mod_on = [m if p.device == m.device else torch.empty_like(m, device=p.device)
                       for row in grid for p, m in zip(row, self.modifiers)]
        if adaptive:
            self.coeffs = torch.ones(n_taps, device=home)
            self.prev = torch.ones(n_taps, device=home)
            self.coeffs_on = [self.coeffs if p.device == home
                              else torch.ones(n_taps, device=p.device) for p in self.positions]
        self.adam_graphs: list = []
        if self.whole:
            self.graphs = [StepGraph(self._whole_step, home, enabled=graphs)]
            return
        self.cost_on = [torch.zeros((), device=p.device) for p in self.positions]
        self.signal_on = [torch.zeros(len(range(n_taps)[p.taps]), device=p.device)
                          if adaptive else None for p in self.positions]
        self.graphs = [StepGraph(functools.partial(self._position_step, q), p.device,
                                 enabled=graphs) for q, p in enumerate(self.positions)]
        if self.summed:
            self.grad_on = [p.grad_buf if p.grad_buf is not None else torch.empty_like(p.frames)
                            for p in self.positions]
            self.grad_sum = [torch.empty_like(m) for m in self.modifiers]
            self.adam_graphs = [StepGraph(functools.partial(self._adam_step, f), m.device,
                                          enabled=graphs) for f, m in enumerate(self.modifiers)]

    def reset(self, inits, opt_init, coeffs0) -> None:
        for q, (m, adam) in enumerate(zip(self.modifiers, self.adams)):
            if inits is None:
                m.fill_(MODIFIER_INIT)
            else:
                m.copy_(inits[q])
            adam.reset(None if opt_init is None else opt_init[q])
        self.k.zero_()
        if self.adaptive:
            self.coeffs.copy_(coeffs0)
            self.prev.fill_(1.0)

    def _next_coeffs(self) -> None:
        # coeffs = softmax(softmax(prev_loss) + momentum·coeffs), before the
        # step's loss (TPAMI_attack.py:263-265)
        self.coeffs.copy_(torch.softmax(torch.softmax(self.prev, dim=0)
                                        + self.momentum * self.coeffs, dim=0))

    def _whole_step(self) -> None:
        adam = self.adams[0]
        if self.adaptive:
            self._next_coeffs()
        cost, signal, grad = self.grad_of(self.positions[0], self.modifiers[0],
                                          self.coeffs if self.adaptive else None)
        with torch.no_grad():
            if self.adaptive:
                self.prev.copy_(signal)
            self.costs.index_copy_(0, adam.k, cost.reshape(1))
        adam.step(grad)

    def _position_step(self, q: int) -> None:
        cost, signal, grad = self.grad_of(self.positions[q], self.mod_on[q],
                                          self.coeffs_on[q] if self.adaptive else None)
        with torch.no_grad():
            self.cost_on[q].copy_(cost)
            if signal is not None:
                self.signal_on[q].copy_(signal)
            if self.summed:
                if grad is not self.grad_on[q]:
                    self.grad_on[q].copy_(grad)
                return
        self.adams[q].step(grad)

    def _adam_step(self, f: int) -> None:
        self.adams[f].step(self.grad_sum[f])

    def step(self) -> None:
        if self.whole:
            self.graphs[0]()
            return
        with torch.no_grad():
            if self.adaptive:
                self._next_coeffs()
            # the copies go out to every card before any position's work is
            # queued (see ensemble.py: a copy queues behind its card's work)
            if self.adaptive:
                for c in self.coeffs_on:
                    if c is not self.coeffs:
                        c.copy_(self.coeffs)
            for q, m in enumerate(self.mod_on):
                held = self.modifiers[q % self.cols]
                if m is not held:
                    m.copy_(held)
        for graph in self.graphs:
            graph()
        with torch.no_grad():
            for f, total in enumerate(self.grad_sum if self.summed else ()):
                acc = None
                for q in range(f, len(self.positions), self.cols):
                    acc = _acc(acc, self.grad_on[q], total.device)
                total.copy_(acc)
        for graph in self.adam_graphs:
            graph()
        with torch.no_grad():
            cost = None
            for c in self.cost_on:
                cost = _acc(cost, c, self.home)
            self.costs.index_copy_(0, self.k, cost.reshape(1))
            self.k.add_(1)
            if self.adaptive:
                # each group's taps summed over its row, the groups in order
                rows = [self.signal_on[g * self.cols:(g + 1) * self.cols]
                        for g in range(len(self.grid))]
                signals = []
                for row in rows:
                    acc = None
                    for s in row:
                        acc = _acc(acc, s, self.home)
                    signals.append(acc)
                self.prev.copy_(signals[0] if len(signals) == 1 else torch.cat(signals))

    def adversarial(self, epsilon: float) -> torch.Tensor:
        """The (B·T, 3, H, W) adversarial frames of the modifiers, whole on
        the first position's device (K1 once a column)."""
        with torch.no_grad():
            return _cat([kernels.rebuild_adv(p.frames, m, epsilon)
                         for p, m in zip(self.grid[0], self.modifiers)], self.home)


def make_sharded_i2v_runner(
    models: Sequence[ImageModel],
    mesh: Optional[Mesh] = None,
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
    graphs: bool = True,
):
    """Build an I2V / ENS-I2V (``adaptive=False``) or AENS-I2V-MF runner.

    ``runner(clean01 (B,C,T,H,W) in [0,1], n_real=None, mod_init=None,
    opt_init=None) -> (adv01 clips, per-step costs)``.

    Without a ``mesh`` it runs on ``device`` (default: the surrogates'
    device). With one, position *p* of its ``mesh.size`` positions (in
    row-major order over ``('data', 'frames')``) holds frames
    ``[p·n/P, (p+1)·n/P)`` of the B·T batch, their modifier slice and their
    optimizer state, and runs them through its device's replica of the
    surrogates (:func:`replicate`, made once a distinct device). The cost,
    and AENS's per-tap signal, are summed over the positions in order on
    the first position's device, where the coefficients, the costs and the
    gathered outputs live. No step waits on the host, so the launches of
    position p+1 queue while position p's kernels run. The batch's B·T
    must divide over the positions (:class:`ShardedImageGuidedAttack`
    pads); ``clean01`` may also come laid out by the mesh's clip sharding
    (:class:`~.mesh.Sharded`), its pieces already on their devices.

    - ``frame_chunk``: accumulate the gradient over chunks of this many
      frames (``"auto"``: :func:`resolve_frame_chunk`); the clean taps are
      collected chunk by chunk too. Costs and gradients are the full batch's.
      On a mesh the chunk is the batch's, cut over the positions
      (:func:`_local_chunk`).
    - ``mod_init`` warm-starts from a caller-built modifier in the
      (B·T, 3, H, W) frame layout instead of the 0.01/255 fill;
      ``return_modifier`` appends the final, unclipped modifier.
    - ``opt_state_io`` takes ``opt_init = (step, exp_avg, exp_avg_sq)``,
      torch Adam's state (the JAX runner's ``(count, mu, nu)``; see
      :mod:`i2v_tpu_torch.models.convert`), and appends the final one:
      chained segments equal one run of all their steps, bit for bit.
      The modifier and the moments go in and come out whole, in frame order.
    - ``n_real`` marks the trailing clips of a padded batch as pad.
    - AENS's coefficients persist across runner calls, as the reference's
      instance state does; the previous per-tap loss resets on each call.
    - ``param_dtype=torch.bfloat16`` stores the surrogates' weights in bf16
      (:func:`cast_param_storage`, before they are replicated); each
      surrogate computes in its own dtype (``get_image_models(..., dtype=)``),
      which also sizes the ``"auto"`` chunk (:func:`compute_dtype_of`).
    - ``remat`` recomputes the surrogates' forward in the backward
      (``torch.utils.checkpoint``), holding only the taps.
    - ``mu_dtype=torch.bfloat16`` stores Adam's first moment in bf16 and
      steps as the JAX runner's optax Adam does (:class:`_AdamMu`), not as
      ``torch.optim.Adam``; ``opt_init``/``opt_state_io`` then carry
      ``(count, mu, nu)`` with ``mu`` in ``mu_dtype``.
    - ``graphs`` (default): on a card each step is a CUDA graph, captured at
      the second step of the first call of a batch layout and replayed from
      then on, calls of the same layout included (:class:`_Loop`,
      :mod:`i2v_tpu_torch.utils.graphs`); ``graphs=False`` runs the same
      steps eagerly, to compare and time them.

    ``runner.value_and_grad(clean01, modifier, n_real=None)`` gives the
    first step's cost and its gradient w.r.t. ``modifier``, chunked as the
    runner chunks, without a step; ``runner.coefficients()`` the AENS
    coefficients the last call left; ``runner.loops`` the :class:`_Loop` of
    each batch layout met so far."""
    if mu_dtype is not None and not (isinstance(mu_dtype, torch.dtype)
                                     and mu_dtype.is_floating_point):
        raise ValueError(f"mu_dtype must be a floating torch dtype, got {mu_dtype!r}")
    if isinstance(frame_chunk, str) and frame_chunk != "auto":
        raise ValueError(f"frame_chunk must be an int, None, or 'auto'; got {frame_chunk!r}")
    models = list(models)
    if param_dtype is not None:
        models = cast_param_storage(models, param_dtype)
    if mesh is None:
        home = torch.device(device) if device is not None else models[0].device
        devices, replicas = [home], {home: models}
    else:
        devices = mesh.positions
        home = devices[0]
        replicas = {d: replicate(models, d) for d in mesh.distinct_devices}
    n_pos = len(devices)
    n_taps = sum(len(m.tap_keys) for m in models)
    compute_dtype = compute_dtype_of(models)
    grad_of = functools.partial(_position_grad, epsilon=epsilon, adaptive=adaptive,
                                coef_ce=coef_ce, n_taps=n_taps, remat=remat)

    # AENS's coefficients persist across calls (TPAMI_attack.py:165,265)
    coeffs_box = [torch.ones(n_taps, dtype=torch.float32, device=home)]

    def frame_slices(clean01):
        """→ (B, T, each position's frames) of clips in [0,1], whole or laid
        out by the mesh's clip sharding."""
        if isinstance(clean01, Sharded):
            if clean01.sharding.mesh != mesh or clean01.sharding.axes != ("data",):
                raise ValueError("a laid-out clip batch must come in this runner's mesh's "
                                 "clip sharding")
            b, _, t = clean01.shape[:3]
            cols = mesh.shape["frames"]
            rows = clean01.map(lambda c: pixel.flatten_clip_to_frames(c.to(torch.float32)))
            if rows.pieces[0].shape[0] % cols:
                raise ValueError(f"{rows.pieces[0].shape[0]} frames a mesh row do not divide "
                                 f"over its {cols} positions")
            return b, t, [_slices(row, cols)[p % cols] for p, row in enumerate(rows.pieces)]
        clean01 = torch.as_tensor(clean01).to(home, torch.float32)
        b, _, t = clean01.shape[:3]
        frames = pixel.flatten_clip_to_frames(clean01)
        del clean01
        if (b * t) % n_pos:
            raise ValueError(f"{b * t} frames do not divide over the mesh's {n_pos} positions")
        if n_pos == 1:
            return b, t, [frames]
        return b, t, [move(f, d) for f, d in zip(_slices(frames, n_pos), devices)]

    def positions_of(frames: list, mask) -> list:
        hw = frames[0].shape[2:]
        chunk = _local_chunk(frame_chunk, frames[0].shape[0] * n_pos, hw, compute_dtype, n_pos)
        masks = [None] * n_pos if mask is None else _slices(mask, n_pos)
        return [_position(replicas[d], f, chunk, None if m is None else move(m, d),
                          slice(0, n_taps))
                for d, f, m in zip(devices, frames, masks)]

    # the loops by batch layout, as the JAX runner's jit caches by shape
    loops: dict = {}

    def loop_for(clean01, n_real) -> tuple[int, _Loop]:
        b, t, frames = frame_slices(clean01)
        mask = frame_mask(b, t, n_real, home)
        key = (tuple(tuple(f.shape) for f in frames), mask is None)
        loop = loops.get(key)
        if loop is None:
            loop = loops[key] = _Loop(
                [positions_of(frames, mask)], home, steps=steps, step_size=step_size,
                mu_dtype=mu_dtype, adaptive=adaptive, aens_momentum=aens_momentum,
                n_taps=n_taps, grad_of=grad_of, graphs=graphs)
        else:
            masks = [None] * n_pos if mask is None else _slices(mask, n_pos)
            for pos, f, m in zip(loop.positions, frames, masks):
                _load(pos, f, None if m is None else move(m, pos.device))
        return b, loop

    def runner(clean01, n_real=None, mod_init=None, opt_init=None):
        with span("i2v.call", unit=next_number("i2v.call"), device=home):
            with span("i2v.clean_taps", device=home):
                b, loop = loop_for(clean01, n_real)
            inits = None if mod_init is None else _slices(mod_init, n_pos)
            if opt_init is not None:
                count, first, second = opt_init
                opt_init = [(count, m, v) for m, v in zip(_slices(first, n_pos),
                                                         _slices(second, n_pos))]
            loop.reset(inits, opt_init, coeffs_box[0])
            with span("i2v.steps", device=home):
                for _ in range(steps):
                    loop.step()
            with span("i2v.handback", device=home):
                if adaptive:
                    coeffs_box[0] = loop.coeffs.clone()
                out = (pixel.unflatten_frames_to_clip(loop.adversarial(epsilon), b),
                       loop.costs.clone())
                if return_modifier:
                    out = out + (_cat([m.clone() for m in loop.modifiers], home),)
                if opt_state_io:
                    states = [adam.state() for adam in loop.adams]
                    out = out + ((states[0][0], _cat([s[1] for s in states], home),
                                  _cat([s[2] for s in states], home)),)
            return out

    def value_and_grad(clean01, modifier, n_real=None):
        b, t, frames = frame_slices(clean01)
        positions = positions_of(frames, frame_mask(b, t, n_real, home))
        coeffs = None
        if adaptive:
            ones = torch.ones(n_taps, dtype=torch.float32, device=home)
            coeffs = torch.softmax(torch.softmax(ones, dim=0) + aens_momentum * coeffs_box[0],
                                   dim=0)
        cost, grads = None, []
        for pos, mod in zip(positions, _slices(modifier, n_pos)):
            c, _, g = grad_of(pos, mod.to(pos.frames),
                              None if coeffs is None else move(coeffs, pos.device))
            grads.append(g)
            cost = _acc(cost, c, home)
        return cost, _cat(grads, home)

    runner.value_and_grad = value_and_grad
    runner.coefficients = lambda: coeffs_box[0]
    runner.loops = loops
    return runner


def pad_to_mesh(videos, data: int, cols: int, t_axis: int):
    """``(videos, pad)``: the batch with ``pad`` repeats of its last clip
    appended, the fewest that make B a multiple of ``data`` and B·T one of
    ``data · cols`` (``i2v_tpu/parallel/sharded.py:413-426``); the pad clips
    are then masked inert by the runner's ``n_real`` and sliced off."""
    b, t = videos.shape[0], videos.shape[t_axis]
    target = b + (-b % data)
    while (target * t) % (data * cols):
        target += data
    if target == b:
        return videos, 0
    videos = torch.as_tensor(videos)
    return torch.cat([videos, videos[-1:].expand(target - b, *videos.shape[1:])]), target - b


def _clean01_in_place(videos: torch.Tensor) -> torch.Tensor:
    """A piece of a normalized (or raw uint8) clip batch → [0,1] float32 on
    the piece's own device (:meth:`Attack._clean01`'s arithmetic)."""
    if pixel.is_u8_clips(videos):
        return pixel.ingest_u8_clips(videos, videos.device)
    return pixel.unnormalize(videos.to(torch.float32), channel_axis=1)


class ShardedImageGuidedAttack(Attack):
    """The runner behind the attack classes' calling convention
    (``attack(videos, labels, video_names) -> normalized adversarial
    clips``), for ``image_main --sharded``: per-step costs go into
    ``loss_info``. With ``multigrid > 0`` it runs the coarse-to-fine
    schedule (:mod:`.multigrid`). Over a ``mesh``, a trailing batch that
    does not divide over it is padded with repeats of its last clip, which
    the runner masks inert (they change neither the real clips' output nor
    the recorded costs nor AENS's coefficients) and which are sliced off
    (``i2v_tpu/parallel/sharded.py:401-440``); a batch laid out by the
    mesh's clip sharding (``make_input_pipeline(mesh=)``) goes in as its
    pieces."""

    def __init__(self, models: Sequence[ImageModel], mesh: Optional[Mesh] = None, *, steps: int,
                 step_size: float, adaptive: bool = False, aens_momentum: float = 0.0,
                 coef_ce: bool = False, name: str = "ShardedI2V",
                 frame_chunk: int | str | None = None, param_dtype: Optional[torch.dtype] = None,
                 multigrid: int = 0, multigrid_scale: int = 2, graphs: bool = True):
        models = list(models)
        super().__init__(name, None,
                         device=models[0].device if mesh is None else mesh.positions[0])
        self.steps = steps
        self.mesh = mesh
        if multigrid:
            if adaptive:
                raise ValueError("--multigrid does not compose with the adaptive AENS "
                                 "coefficients (their per-tap signal is resolution-coupled)")
            from .multigrid import make_multigrid_i2v_runner

            self._runner = make_multigrid_i2v_runner(
                models, mesh, steps=steps, coarse_steps=multigrid, scale=multigrid_scale,
                step_size=step_size, frame_chunk=frame_chunk, param_dtype=param_dtype,
                graphs=graphs)
        else:
            self._runner = make_sharded_i2v_runner(
                models, mesh, steps=steps, step_size=step_size, adaptive=adaptive,
                aens_momentum=aens_momentum, coef_ce=coef_ce, frame_chunk=frame_chunk,
                param_dtype=param_dtype, graphs=graphs)

    def __call__(self, videos, labels=None, video_names=None) -> torch.Tensor:
        pad = 0
        if isinstance(videos, Sharded):
            clean01 = videos.map(_clean01_in_place)
        else:
            if self.mesh is not None:
                t_axis = 1 if pixel.is_u8_clips(videos) else 2
                videos, pad = pad_to_mesh(videos, self.mesh.shape["data"],
                                          self.mesh.shape["frames"], t_axis)
            # the normalized clips are not kept: the runner's flattened frames
            # replace them on the device
            clean01 = self._clean01(videos)
        b = clean01.shape[0] - pad
        adv01, costs = self._runner(clean01, n_real=b if pad else None)
        self._record_costs(costs, video_names)
        return pixel.normalize(adv01[:b] if pad else adv01, channel_axis=1)
