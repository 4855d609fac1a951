"""Hand-written Hopper kernels and their wrappers.

``rebuild_adv(clean01, modifier, epsilon)`` — the differentiable modifier
rebuild ``clamp(clean + clamp(modifier, ±ε), 0, 1)`` that every Adam step of
the image-guided attacks runs twice over (forward, then backward).

Replaces the Pallas custom-VJP pair of ``i2v_tpu/ops/pallas_kernels.py``
(``_rebuild_fwd_kernel`` and ``_rebuild_bwd_kernel``, reached through
``rebuild_adv``) with two CUDA kernels in ``csrc/rebuild_adv.cu``, built with
``nvcc`` for sm_90a at first use (:mod:`._build`). Both are elementwise and
bound by device-memory bytes: 12 bytes an element forward, 16 backward. The
kernels make one grid-stride pass with 16-byte vector accesses and a scalar
tail; the source says more.

Dispatch: a tensor on the CPU takes the plain version in
:mod:`i2v_tpu_torch.ops.pixel`; a CUDA tensor launches the kernel or raises.
There is no fallback from the card to the plain version. ``launches`` counts
kernel launches, so that a run can show it went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, pixel

launches = {"rebuild_fwd": 0, "rebuild_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def library() -> _build.BuiltLibrary:
    """Build (once per process) and load the rebuild kernels."""
    lib = _build.build("rebuild_adv")
    ptr = ctypes.c_void_p
    lib.cdll.rebuild_adv_fwd.argtypes = [ptr, ptr, ptr, ctypes.c_int64, ctypes.c_float, ptr]
    lib.cdll.rebuild_adv_fwd.restype = ctypes.c_int
    lib.cdll.rebuild_adv_bwd.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int64, ctypes.c_float,
                                         ptr]
    lib.cdll.rebuild_adv_bwd.restype = ctypes.c_int
    return lib


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
        err = library().cdll.rebuild_adv_fwd(
            clean01.data_ptr(), modifier.data_ptr(), out.data_ptr(), modifier.numel(),
            eps32, _stream(modifier))
    _raise_on(err, "rebuild_fwd")
    launches["rebuild_fwd"] += 1
    return out


def launch_rebuild_bwd(clean01: torch.Tensor, modifier: torch.Tensor, grad: torch.Tensor,
                       eps32: float) -> torch.Tensor:
    """K2: ``dm = g · [−ε ≤ m ≤ ε] · [0 ≤ clean + clamp(m, ±ε) ≤ 1]`` on the card."""
    _check("rebuild_bwd", clean01, modifier, grad)
    dmod = torch.empty_like(modifier)
    with torch.cuda.device(modifier.device):
        err = library().cdll.rebuild_adv_bwd(
            clean01.data_ptr(), modifier.data_ptr(), grad.data_ptr(), dmod.data_ptr(),
            modifier.numel(), eps32, _stream(modifier))
    _raise_on(err, "rebuild_bwd")
    launches["rebuild_bwd"] += 1
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
