"""Compiled loops: each attack step, and each evaluation forward, captured once
per input shape as a CUDA graph and replayed.

The JAX package compiles each loop once per input shape and runs it with no
host round trip a step: one ``lax.scan`` under one ``jit``, cached by shape
(``i2v_tpu/attacks/core.py:7-8``, ``i2v_tpu/attacks/i2v.py:105,139-144``).
Here the host still drives the loop, but every step after the first is one
graph launch instead of hundreds of kernel launches.

A *capture-ready* step reads only static device buffers and writes its
results into them. It reads nothing back to the host (no ``.item()``,
``float(tensor)``, ``.tolist()`` or data-dependent shape), copies nothing
from the host, and keeps no tensor it allocates past its end. The engines
hold such steps with their buffers in a cache keyed by the input's shape,
so that a second batch of one shape copies its inputs in, resets its state
and replays.

:class:`StepGraph` runs a capture-ready step:

  - on a CUDA device, the first call eagerly: that is step 0 of the real
    trajectory, and it makes cuDNN's algorithm choice, loads the kernel
    libraries and runs autograd's first pass. The second call frees the
    eager step's cached blocks, captures one step and replays it; every
    later call replays. A capture that fails raises: there is no eager
    fallback on the card;
  - on any other device (the CPU, the meta device), every call eagerly.

Graphs of one device share one private memory pool (:func:`pool`). They
never run at once: every replay goes on the caller's current stream, and no
graph leaves a live tensor in the pool (their outputs are static buffers
made outside it), so that the pool holds the largest step's working set and
not the sum of them.

The kernels of :mod:`i2v_tpu_torch.ops.kernels` count their launches in
Python, which runs once, at capture. The capture's tally of them is added to
``kernels.launches`` at every replay, so that the counts stay true.

:class:`TableAdam` is Adam as a capture-ready step: the per-step scalars
(bias corrections, the step size) come from a small device table that the
host fills before the loop, in the arithmetic of the eager optimizer it
stands for, indexed by a device step counter. :class:`DrawTable` does the
same for a loop's random draws (DI-FGSM's resize and pads,
TemporalTranslation's random shifts): the host makes a whole call's draws
from the call's generator before the loop, in the order the eager loop
made them a step, and each step reads its row on the device.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Optional

import numpy as np
import torch

_pools: dict = {}
_live: dict = {}  # device → the StepGraphs holding a graph in its pool
_streams: dict = {}
# every capture of the process: how many, and their one-off host seconds
captures = {"graphs": 0, "seconds": 0.0}


def pool(device: torch.device):
    """The private memory pool that the next graph on ``device`` captures
    into: the one its live graphs share, or a new one when none is alive (a
    pool is given back with the last graph that used it, and cannot be
    captured into again)."""
    if not _live.setdefault(device, weakref.WeakSet()):
        with torch.cuda.device(device):
            _pools[device] = torch.cuda.graph_pool_handle()
    return _pools[device]


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device=device)
    return _streams[device]


class StepGraph:
    """A capture-ready ``step()``, run eagerly once and then replayed as one
    CUDA graph on ``device``; ``enabled=False`` (or a device that is not a
    card) runs every call eagerly. Each capture adds its one-off host
    seconds to ``captures``."""

    def __init__(self, step: Callable[[], None], device, *, enabled: bool = True):
        self.step = step
        self.device = torch.device(device)
        self.enabled = enabled and self.device.type == "cuda"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: dict = {}
        self._warm = False

    def __call__(self) -> None:
        if not self.enabled:
            self.step()
            return
        if self.graph is None:
            if not self._warm:
                self._warm = True
                self.step()
                return
            self._capture()
        from ..ops import kernels

        with torch.cuda.device(self.device):
            self.graph.replay()
        kernels.add_launches(self.launches)

    def _capture(self) -> None:
        from ..ops import kernels

        kernels.build_all()  # no nvcc and no dlopen inside a capture
        t0 = time.perf_counter()
        # graphs no longer referenced are freed now: a collection that ran
        # inside the capture would destroy them on the capturing thread,
        # which the capture does not permit (it fails)
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(self.device):
                # torch.cuda.graph synchronizes and empties the cache first:
                # the eager step's cached blocks go back to the card before
                # the pool takes one step's working set. The error mode is the
                # capturing thread's: the artifact writer and the prefetch
                # thread pin and copy meanwhile, and autograd's device thread
                # records the backward onto the capture stream.
                with kernels.capture_tally() as tally:
                    with torch.cuda.graph(graph, pool=pool(self.device),
                                          stream=_capture_stream(self.device),
                                          capture_error_mode="thread_local"):
                        self.step()
        finally:
            if collecting:
                gc.enable()
        self.graph, self.launches = graph, {k: n for k, n in tally.items() if n}
        _live[self.device].add(self)
        captures["graphs"] += 1
        captures["seconds"] += time.perf_counter() - t0


class TableAdam:
    """Adam on ``param`` in place, one capture-ready :meth:`step` at a time,
    for a loop of ``steps`` steps.

    Without ``mu_dtype`` it is ``torch.optim.Adam(lr, betas=(0.9, 0.999),
    eps=1e-8, foreach=False)``; with it, optax's ``adam(..., mu_dtype=)``
    as the JAX runner steps (the first moment stored in ``mu_dtype``, the
    bias corrections dividing the moments). Either way the step-dependent
    scalars come from ``table``, one row a step, which :meth:`reset` fills
    on the host as the eager optimizer computes them: torch's in float64
    (``1 − β**step``, ``lr / bc1``, ``bc2 ** 0.5``), optax's in float32
    (``decay**count``). The update then applies each scalar as the eager
    optimizer's kernels apply a host number on that device: the CPU divides
    by it, the card multiplies by its reciprocal (taken in double, rounded
    to float32), so the table holds whichever of the two the device uses,
    and ``addcdiv``'s product with the step size is spelt as each device's
    kernel rounds it. The update equals the eager optimizer's bit for bit
    on the CPU (the tests) and on the card (``chip_smoke.py``).

    ``k`` is the device step counter; :meth:`state` gives ``(count,
    exp_avg, exp_avg_sq)`` after the loop, the count as a float32 scalar on
    the host, as ``torch.optim.Adam`` keeps its step."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, param: torch.Tensor, lr: float, steps: int,
                 mu_dtype: Optional[torch.dtype] = None):
        self.param, self.lr, self.steps, self.mu_dtype = param, lr, steps, mu_dtype
        dev = param.device
        self.on_cpu = dev.type == "cpu"
        self.exp_avg = torch.zeros_like(param, dtype=mu_dtype or param.dtype)
        self.exp_avg_sq = torch.zeros_like(param)
        self.table = torch.zeros((steps, 2), dtype=torch.float32, device=dev)
        self.k = torch.zeros(1, dtype=torch.long, device=dev)
        self.count0 = 0
        if mu_dtype is not None:
            # made once: a tensor built from a Python number on a card is a
            # copy that makes the host wait for the card
            self.b1 = torch.tensor(self.B1, dtype=mu_dtype).to(dev)

    def rows(self, count0: int) -> np.ndarray:
        """The table of steps ``count0 + 1 … count0 + steps``."""
        rows = []
        for t in range(count0 + 1, count0 + self.steps + 1):
            if self.mu_dtype is None:
                # torch.optim.Adam's non-capturable step, from its float step
                step = float(t)
                bc1 = 1 - self.B1 ** step
                bc2_sqrt = (1 - self.B2 ** step) ** 0.5
                divisors, step_size = [bc2_sqrt], -(self.lr / bc1)
            else:
                # optax: 1 − decay**count in float32
                c = np.float32(t)
                divisors = [np.float32(1) - np.float32(self.B1) ** c,
                            np.float32(1) - np.float32(self.B2) ** c]
                step_size = None
            # the card divides a tensor by a host number as a product with its
            # reciprocal, taken in double and rounded once to float32
            row = [np.float32(d) if self.on_cpu else np.float32(1.0 / float(d))
                   for d in divisors]
            rows.append(row + ([] if step_size is None else [np.float32(step_size)]))
        return np.asarray(rows, dtype=np.float32).reshape(self.steps, 2)

    def reset(self, opt_init=None) -> None:
        """Zeros, or ``opt_init = (count, exp_avg, exp_avg_sq)``, and the
        table from that count on. Not capture-ready: the host fills it."""
        if opt_init is None:
            self.count0 = 0
            self.exp_avg.zero_()
            self.exp_avg_sq.zero_()
        else:
            count, first, second = opt_init
            self.count0 = int(torch.as_tensor(count))
            self.exp_avg.copy_(first.detach())
            self.exp_avg_sq.copy_(second.detach())
        self.table.copy_(torch.from_numpy(self.rows(self.count0)))
        self.k.zero_()

    @torch.no_grad()
    def step(self, grad: torch.Tensor) -> None:
        row = self.table.index_select(0, self.k)[0]
        a, b = row[0], row[1]
        if self.mu_dtype is None:
            self.exp_avg.lerp_(grad, 1 - self.B1)
            self.exp_avg_sq.mul_(self.B2).addcmul_(grad, grad, value=1 - self.B2)
            root = self.exp_avg_sq.sqrt()
            denom = (root / a if self.on_cpu else root * a).add_(self.EPS)
            if self.on_cpu:
                # addcdiv's CPU kernel: self + (value·t1)/t2
                self.param.add_(self.exp_avg * b / denom)
            else:
                # addcdiv's CUDA kernel: self + value·(t1/t2), each rounded
                self.param.addcmul_(self.exp_avg / denom, b)
        else:
            mu = (1 - self.B1) * grad + (self.b1 * self.exp_avg).float()
            self.exp_avg_sq.copy_((1 - self.B2) * (grad * grad) + self.B2 * self.exp_avg_sq)
            if self.on_cpu:
                update = (mu / a) / (torch.sqrt(self.exp_avg_sq / b) + self.EPS)
            else:
                update = (mu * a) / (torch.sqrt(self.exp_avg_sq * b) + self.EPS)
            self.param.add_(update * -self.lr)
            self.exp_avg.copy_(mu.to(self.exp_avg.dtype))
        self.k.add_(1)

    def state(self):
        return (torch.tensor(float(self.count0 + self.steps)), self.exp_avg.clone(),
                self.exp_avg_sq.clone())


class DrawTable:
    """A loop's host draws as a capture-ready read: a ``(steps, width)``
    int64 table on ``device``, one row a step. :meth:`fill` copies a call's
    rows in (once a call, before the loop; not capture-ready) and restarts
    the device step counter ``k``; :meth:`row` gives the step's row as a
    device tensor and moves ``k`` on, so that a captured step reads the next
    row at every replay. Every reader of a step's draws (each clip-batch
    chunk, each mesh piece) takes the one row the step read."""

    def __init__(self, rows: np.ndarray, device):
        self.table = torch.from_numpy(np.array(rows, dtype=np.int64)).to(device)
        self.k = torch.zeros(1, dtype=torch.long, device=device)

    def fill(self, rows: np.ndarray) -> None:
        self.table.copy_(torch.from_numpy(np.array(rows, dtype=np.int64)))
        self.k.zero_()

    def row(self) -> torch.Tensor:
        row = self.table.index_select(0, self.k)[0]
        self.k.add_(1)
        return row
