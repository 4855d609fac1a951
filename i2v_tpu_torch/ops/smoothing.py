"""Gradient and perturbation smoothing kernels, and temporal moves.

PyTorch counterpart of :mod:`i2v_tpu.ops.smoothing`: the translation-
invariance Gaussian kernels (reference: base_attacks.py:427-445, 626-649),
TAP's uniform smoothing kernels (base_attacks.py:713-735), and
TemporalTranslation's 1-D temporal kernels and cycle moves
(video_attacks.py:38-148).

The JAX package smooths with banded matmuls and selects frames with one-hot
contractions, because gathers and 3-channel depthwise convs are slow on the
TPU. On the card a matmul may run in TF32 and a cuDNN conv does by default,
which would quantize both. So here every smoothing is a sum of shifted
slices (:func:`correlate`: float32 elementwise work in every precision mode,
one pass a kernel tap) and every frame selection is ``torch.roll`` or
``index_select``, exact in every mode. The kernel builders are numpy copies
of the JAX package's.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Kernel construction (numpy, float32)
# ---------------------------------------------------------------------------


def _norm_pdf(x: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def ti_kernel_2d(kernlen: int = 15, nsig: float = 3.0) -> np.ndarray:
    """Translation-invariance 2-D Gaussian (reference: base_attacks.py:427-432)."""
    k1 = _norm_pdf(np.linspace(-nsig, nsig, kernlen))
    k2 = np.outer(k1, k1)
    return (k2 / k2.sum()).astype(np.float32)


def ti_kernel_3d(kernlen: int = 15, nsig: float = 3.0) -> np.ndarray:
    """Separable 3-D Gaussian: k3[i] = k1[i]·outer(k1,k1), normalized
    (reference: base_attacks.py:626-634)."""
    k1 = _norm_pdf(np.linspace(-nsig, nsig, kernlen))
    k3 = k1[:, None, None] * np.outer(k1, k1)[None]
    return (k3 / k3.sum()).astype(np.float32)


def uniform_kernel_2d(kernlen: int) -> np.ndarray:
    """TAP's uniform 2-D kernel (reference: base_attacks.py:713-717)."""
    k = np.ones((kernlen, kernlen))
    return (k / k.sum()).astype(np.float32)


def uniform_kernel_3d(kernlen: int, temporal_kernlen: int) -> np.ndarray:
    """TAP's uniform 3-D kernel (reference: base_attacks.py:719-722)."""
    k = np.ones((temporal_kernlen, kernlen, kernlen))
    return (k / k.sum()).astype(np.float32)


def temporal_kernel(kernlen: int, mode: str = "gaussian") -> np.ndarray:
    """TemporalTranslation's 1-D kernel over the cycle-shift variants
    (reference: video_attacks.py:52-79). Modes: gaussian, linear, uniform
    (the reference spells uniform 'random')."""
    if mode == "gaussian":
        assert kernlen % 2 == 1
        if kernlen == 1:
            # sigma would be 0 and the kernel 0/0; a length-1 kernel is the
            # identity whatever the mode
            return np.ones((1,), np.float32)
        k = (kernlen - 1) / 2
        sigma = k / 3.0
        xs = np.arange(-int(k), int(k) + 1, dtype=np.float64)
        k1 = np.exp(-(xs**2) / (2 * sigma**2)) / (sigma * math.sqrt(2 * math.pi))
    elif mode == "linear":
        k = int((kernlen - 1) / 2)
        ramp = [1 - i / (k + 1) for i in range(k + 1)]
        k1 = np.array(ramp[::-1][:-1] + ramp)
    elif mode in ("uniform", "random"):
        k1 = np.ones(kernlen)
    else:
        raise ValueError(f"unknown temporal kernel mode {mode!r}")
    return (k1 / k1.sum()).astype(np.float32)


def gaussian_1d(kernlen: int = 15, nsig: float = 3.0) -> np.ndarray:
    """The 1-D Gaussian factor of the TI kernels (reference:
    base_attacks.py:427-429)."""
    return _norm_pdf(np.linspace(-nsig, nsig, kernlen)).astype(np.float32)


# ---------------------------------------------------------------------------
# SAME-padded depthwise smoothing over clip tensors (B, C, T, H, W)
# ---------------------------------------------------------------------------


def _correlate(x: torch.Tensor, kernel: np.ndarray, dims: Sequence[int]) -> torch.Tensor:
    """``out[i] = Σ_s kernel[s + r]·x[i + s]`` over ``dims``, x zero outside:
    one shifted slice of the zero-padded input a kernel tap, accumulated in
    float32 in the kernel's row-major order."""
    pad = [0, 0] * x.ndim
    for d, k in zip(dims, kernel.shape):
        if k % 2 == 0:
            raise ValueError(f"SAME smoothing needs odd kernel sizes, got {kernel.shape}")
        pad[2 * (x.ndim - 1 - d)] = pad[2 * (x.ndim - 1 - d) + 1] = k // 2
    xp = F.pad(x, pad)
    out = None
    for idx in np.ndindex(*kernel.shape):
        sl = xp
        for d, o in zip(dims, idx):
            sl = sl.narrow(d, o, x.shape[d])
        w = float(kernel[idx])
        if out is None:
            out = sl * w
        else:
            out.add_(sl, alpha=w)
    return out


class _Correlate(torch.autograd.Function):
    """:func:`_correlate` with its adjoint as the backward: the SAME
    correlation of the output gradient with the flipped kernel."""

    @staticmethod
    def forward(ctx, x, kernel, dims):
        ctx.kernel, ctx.dims = kernel, dims
        return _correlate(x, kernel, dims)

    @staticmethod
    def backward(ctx, g):
        flipped = np.ascontiguousarray(ctx.kernel[(slice(None, None, -1),) * ctx.kernel.ndim])
        return _correlate(g, flipped, ctx.dims), None, None


def correlate(x: torch.Tensor, kernel, dims: Sequence[int]) -> torch.Tensor:
    """Depthwise SAME zero-padded cross-correlation of ``x`` with one shared
    odd-sized ``kernel`` over the axes ``dims``, differentiable, float32
    whatever the matmul or cuDNN precision mode."""
    kernel = np.asarray(kernel, np.float32)
    if kernel.ndim != len(dims):
        raise ValueError(f"a {kernel.ndim}-D kernel over dims {tuple(dims)}")
    return _Correlate.apply(x, kernel, tuple(dims))


def depthwise_conv2d_frames(grads_bcthw: torch.Tensor, kernel2d) -> torch.Tensor:
    """Per-frame depthwise 2-D smoothing with one shared (H, W) kernel, SAME
    padding (the reference's 32-iteration frame loop, base_attacks.py:434-443)."""
    return correlate(grads_bcthw, kernel2d, (3, 4))


def depthwise_conv3d(grads_bcthw: torch.Tensor, kernel3d) -> torch.Tensor:
    """Depthwise 3-D smoothing over (T, H, W) with one shared kernel, SAME
    padding (reference: base_attacks.py:640, 734)."""
    return correlate(grads_bcthw, kernel3d, (2, 3, 4))


def _unit(k1d) -> np.ndarray:
    k1d = np.asarray(k1d, np.float32)
    return k1d / k1d.sum()


def depthwise_conv3d_separable(grads_bcthw: torch.Tensor, k1d) -> torch.Tensor:
    """Depthwise SAME smoothing with the separable kernel k1d⊗k1d⊗k1d, one
    1-D pass over T, H and W in turn; each factor normalized to sum 1, which
    is the whole kernel's normalization since (k⊗k⊗k).sum() = k.sum()³."""
    k = _unit(k1d)
    x = correlate(grads_bcthw, k, (2,))
    x = correlate(x, k, (3,))
    return correlate(x, k, (4,))


def ti_smooth_2d(grads_bcthw: torch.Tensor, kernel2d) -> torch.Tensor:
    """TIFGSM's gradient smoothing with its re-normalization by mean |g| over
    (C, T, H) only, W left out, as the reference has it (base_attacks.py:444)."""
    out = depthwise_conv2d_frames(grads_bcthw, kernel2d)
    return out / torch.mean(torch.abs(out), dim=(1, 2, 3), keepdim=True)


def ti_smooth_2d_separable(grads_bcthw: torch.Tensor, k1d) -> torch.Tensor:
    """:func:`ti_smooth_2d` with the outer-product Gaussian as two 1-D passes
    over H and W."""
    k = _unit(k1d)
    out = correlate(correlate(grads_bcthw, k, (3,)), k, (4,))
    return out / torch.mean(torch.abs(out), dim=(1, 2, 3), keepdim=True)


# ---------------------------------------------------------------------------
# TemporalTranslation moves and variant smoothing
# ---------------------------------------------------------------------------


def cycle_move(clip_bcthw: torch.Tensor, shift: int) -> torch.Tensor:
    """Circular temporal shift: frame i → (i + shift) mod T (reference:
    video_attacks.py:93-105)."""
    return torch.roll(clip_bcthw, int(shift), dims=2)


def cycle_move_at(clip_bcthw: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """:func:`cycle_move` by a shift held on the device (a 0-d integer
    tensor): output frame i is input frame (i − shift) mod T, one
    ``index_select`` over T, ``torch.roll``'s values with nothing read back
    to the host."""
    frames = clip_bcthw.shape[2]
    src = torch.remainder(torch.arange(frames, device=clip_bcthw.device) - shift, frames)
    return clip_bcthw.index_select(2, src)


def large_move_shift(move: int, frames: int) -> int:
    """'large' move-type shift mapping (reference: video_attacks.py:107-122)."""
    if move == 0:
        return 0
    direction = -1 if move < 0 else 1
    return direction * ((abs(move) + (frames // 2 - 1)) % frames)


def cycle_variants(clip_bcthw: torch.Tensor, shifts) -> torch.Tensor:
    """Stack of cycle-shifted clip variants (D, B, C, T, H, W)."""
    return torch.stack([cycle_move(clip_bcthw, s) for s in shifts])


def exchange_frames(clip_bcthw: torch.Tensor, exchange_pairs) -> torch.Tensor:
    """Swap frame pairs, TemporalTranslation's 'Exchange' move (reference:
    video_attacks.py:142-148; defined there but unused by its forward, kept
    for API parity). One permutation gather, as in the JAX package."""
    perm = list(range(clip_bcthw.shape[2]))
    for a, b in exchange_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return clip_bcthw.index_select(2, torch.tensor(perm, device=clip_bcthw.device))


def smooth_variant_grads(grads_dbcthw: torch.Tensor, kernel1d) -> torch.Tensor:
    """Σ_i kernel1d[i]·grads[i] over the variant axis (reference:
    video_attacks.py:81-91), as float32 elementwise work, not a matmul."""
    w = torch.as_tensor(np.asarray(kernel1d, np.float32), device=grads_dbcthw.device)
    return (w.view((-1,) + (1,) * (grads_dbcthw.ndim - 1)) * grads_dbcthw).sum(0)
