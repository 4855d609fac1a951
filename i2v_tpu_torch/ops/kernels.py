"""Hand-written Hopper kernels and their wrappers.

``rebuild_adv(clean01, modifier, epsilon)`` — the differentiable modifier
rebuild ``clamp(clean + clamp(modifier, ±ε), 0, 1)`` that every Adam step of
the image-guided attacks runs twice over (forward, then backward). Replaces
the Pallas custom-VJP pair of ``i2v_tpu/ops/pallas_kernels.py``
(``_rebuild_fwd_kernel`` and ``_rebuild_bwd_kernel``, reached through
``rebuild_adv``) with two CUDA kernels in ``csrc/rebuild_adv.cu``.

``sign_step_project(adv01, grad, clean01, step_size, epsilon)`` — the pixel
update ``clamp(clean + clamp(adv + α·sign(g) − clean, ±ε), 0, 1)`` that ends
every step of the white-box sign attacks. Replaces the Pallas
``_sign_step_kernel`` (reached through ``sign_step_project``) with the CUDA
kernel in ``csrc/sign_step.cu``. No gradient flows through it: the attack
engine does not differentiate through its pixel update.

Each source is built with ``nvcc`` for sm_90a at first use (:mod:`._build`).
All three kernels are elementwise and bound by device-memory bytes (12, 16
and 16 bytes an element); each makes one grid-stride pass with 16-byte
vector accesses and a scalar tail; the sources say more.

Dispatch: a tensor on the CPU takes the plain version in
:mod:`i2v_tpu_torch.ops.pixel`; a CUDA tensor launches the kernel or raises.
There is no fallback from the card to the plain version. ``launches`` counts
kernel launches, so that a run can show it went through the kernels. A
launch made while a CUDA graph is being captured does not run: it goes
into the capture's tally (:func:`capture_tally`), which
:mod:`i2v_tpu_torch.utils.graphs` adds to ``launches`` at every replay.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build, pixel

launches = {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": 0}
# K2 launches from the autograd engine's thread of each card, so the counts
# take a lock: ``+=`` on a dict entry is a read, an add and a write
_launches_lock = threading.Lock()
# the launches recorded by the capture under way (captures run one at a time)
_tally: dict | None = None


def reset_launches() -> None:
    with _launches_lock:
        for k in launches:
            launches[k] = 0


def count_launch(name: str) -> None:
    """Add one to ``launches[name]``, or to the tally of the capture under
    way, safe under concurrent callers (K2 launches from autograd's thread)."""
    with _launches_lock:
        (launches if _tally is None else _tally)[name] += 1


def add_launches(counts: dict) -> None:
    """Add a replayed graph's launches to ``launches``."""
    with _launches_lock:
        for k, n in counts.items():
            launches[k] += n


@contextlib.contextmanager
def capture_tally():
    """Count the launches recorded while the block captures a CUDA graph
    into the yielded dict instead of ``launches``: nothing runs at capture."""
    global _tally
    tally = dict.fromkeys(launches, 0)
    with _launches_lock:
        _tally = tally
    try:
        yield tally
    finally:
        with _launches_lock:
            _tally = None


_PTR, _N, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# the C entry points of each csrc/{name}.cu and their argument types; every
# pointer and the stream go as c_void_p, so that ctypes never cuts them
SOURCES = {
    "rebuild_adv": {
        "rebuild_adv_fwd": [_PTR, _PTR, _PTR, _N, _F32, _PTR],
        "rebuild_adv_bwd": [_PTR, _PTR, _PTR, _PTR, _N, _F32, _PTR],
    },
    "sign_step": {
        "sign_step_project": [_PTR, _PTR, _PTR, _PTR, _N, _F32, _F32, _PTR],
    },
}


@functools.lru_cache(maxsize=None)
def library(name: str) -> _build.BuiltLibrary:
    """Build (once per process) and load ``csrc/{name}.cu``."""
    lib = _build.build(name)
    for fn, argtypes in SOURCES[name].items():
        getattr(lib.cdll, fn).argtypes = argtypes
        getattr(lib.cdll, fn).restype = ctypes.c_int
    return lib


def build_all() -> dict[str, _build.BuiltLibrary]:
    """Build every kernel source at once, one ``nvcc`` each, in parallel."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(library, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


def _check(name: str, *tensors: torch.Tensor) -> None:
    ref = tensors[0]
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got one on {t.device}")
        if t.device != ref.device:
            raise ValueError(f"{name}: tensors on {t.device} and {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
        if t.shape != ref.shape:
            raise ValueError(f"{name}: shapes {tuple(t.shape)} and {tuple(ref.shape)} differ")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_rebuild_fwd(clean01: torch.Tensor, modifier: torch.Tensor,
                       eps32: float) -> torch.Tensor:
    """K1: ``out = clamp(clean + clamp(m, ±ε), 0, 1)`` on the card."""
    _check("rebuild_fwd", clean01, modifier)
    out = torch.empty_like(modifier)
    with torch.cuda.device(modifier.device):
        err = library("rebuild_adv").cdll.rebuild_adv_fwd(
            clean01.data_ptr(), modifier.data_ptr(), out.data_ptr(), modifier.numel(),
            eps32, _stream(modifier))
    _raise_on(err, "rebuild_fwd")
    count_launch("rebuild_fwd")
    return out


def launch_rebuild_bwd(clean01: torch.Tensor, modifier: torch.Tensor, grad: torch.Tensor,
                       eps32: float) -> torch.Tensor:
    """K2: ``dm = g · [−ε ≤ m ≤ ε] · [0 ≤ clean + clamp(m, ±ε) ≤ 1]`` on the card."""
    _check("rebuild_bwd", clean01, modifier, grad)
    dmod = torch.empty_like(modifier)
    with torch.cuda.device(modifier.device):
        err = library("rebuild_adv").cdll.rebuild_adv_bwd(
            clean01.data_ptr(), modifier.data_ptr(), grad.data_ptr(), dmod.data_ptr(),
            modifier.numel(), eps32, _stream(modifier))
    _raise_on(err, "rebuild_bwd")
    count_launch("rebuild_bwd")
    return dmod


class RebuildAdv(torch.autograd.Function):
    """K1 forward, K2 backward. ``clean01`` gets no gradient."""

    @staticmethod
    def forward(ctx, clean01, modifier, eps32):
        ctx.eps32 = eps32
        ctx.save_for_backward(clean01, modifier)
        return launch_rebuild_fwd(clean01, modifier, eps32)

    @staticmethod
    def backward(ctx, grad):
        clean01, modifier = ctx.saved_tensors
        # autograd may hand over an expanded or strided gradient; the kernel
        # reads a dense one
        dmod = launch_rebuild_bwd(clean01, modifier, grad.contiguous(), ctx.eps32)
        return None, dmod, None


def rebuild_adv(clean01: torch.Tensor, modifier: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Differentiable ``clamp(clean + clamp(modifier, ±ε), 0, 1)``.

    ε is rounded to float32 once, here: both the kernel and the plain version
    compare against that value, so both put the ties in the same places."""
    eps32 = float(np.float32(epsilon))
    if clean01.is_cuda or modifier.is_cuda:
        return RebuildAdv.apply(clean01.detach(), modifier, eps32)
    return pixel.rebuild_adv(clean01.detach(), modifier, eps32)


def launch_sign_step(adv01: torch.Tensor, grad: torch.Tensor, clean01: torch.Tensor,
                     alpha32: float, eps32: float) -> torch.Tensor:
    """K3: ``out = clamp(clean + clamp(adv + α·sign(g) − clean, ±ε), 0, 1)``
    on the card."""
    _check("sign_step", adv01, grad, clean01)
    out = torch.empty_like(adv01)
    with torch.cuda.device(adv01.device):
        err = library("sign_step").cdll.sign_step_project(
            adv01.data_ptr(), grad.data_ptr(), clean01.data_ptr(), out.data_ptr(),
            adv01.numel(), alpha32, eps32, _stream(adv01))
    _raise_on(err, "sign_step")
    count_launch("sign_step")
    return out


def sign_step_project(adv01: torch.Tensor, grad: torch.Tensor, clean01: torch.Tensor,
                      step_size: float, epsilon: float) -> torch.Tensor:
    """``clamp(clean + clamp(adv + α·sign(g) − clean, ±ε), 0, 1)``, with no
    gradient.

    α and ε are rounded to float32 once, here, so that the kernel and the
    plain version step and compare with the same values."""
    alpha32 = float(np.float32(step_size))
    eps32 = float(np.float32(epsilon))
    if adv01.is_cuda or grad.is_cuda or clean01.is_cuda:
        return launch_sign_step(adv01.detach(), grad.detach(), clean01.detach(), alpha32, eps32)
    return pixel.sign_step_project(adv01.detach(), grad.detach(), clean01.detach(),
                                   alpha32, eps32)
