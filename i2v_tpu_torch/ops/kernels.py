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

``bias_act(y, bias, residual, relu)`` — the epilogue of a biased conv,
``act(y + bias[c] (+ residual))`` with act ReLU or the identity, in place on
the conv's output: the surrogates and the I3D, SlowFast and TPN video models
run each conv in cuDNN without its bias and this one pass after it
(:func:`i2v_tpu_torch.models.common.conv_act`). Replaces no Pallas kernel:
XLA fuses the epilogue into the conv on the TPU. The CUDA kernel is
``csrc/bias_act.cu``; its gradient is the one autograd takes through
``relu`` (``threshold_backward``), or SGM's scaled ReLU backward where a
``relu_grad_scale`` other than 1 is given, so it stays differentiable.

``launch_window_attn(qkv, table, ...)`` — the core of the Video Swin
Transformer's window attention (:mod:`i2v_tpu_torch.models.swin3d`),
``softmax(q·scale·kᵀ + bias + mask)·v`` of every (window, head) in one
launch, forward only, from the partitioned qkv into the projection's layout.
Replaces no Pallas kernel: the JAX package has no Swin. The CUDA kernel is
``csrc/window_attn.cu``; it computes in float32 on the CUDA cores whatever
PyTorch's TF32 flags say. It counts in ``launches["window_attn"]`` as the
other kernels count: one a block of an eager forward, and a captured
forward's at each replay.

``launch_pool_attn(q, k, v, rel_t, rel_h, rel_w)`` — the core of MViTv2's
pooling attention (:mod:`i2v_tpu_torch.models.mvit`),
``softmax(q·scale·kᵀ + B)·v + q`` of every (clip, head) in one launch, the
decomposed relative positions ``B`` built from their three per-query terms
inside, forward only, into the projection's layout. Replaces no Pallas
kernel: the JAX package has no MViT. The CUDA kernel is
``csrc/pool_attn.cu``; it computes in float32 on the CUDA cores whatever
PyTorch's TF32 flags say, and counts in ``launches["pool_attn"]``: one a
block of an eager forward, and a captured forward's at each replay.

``launch_pool_qkv(qkv, thw, stride_q, stride_kv, weights, norms, eps)`` —
the pooling of MViTv2's q, k and v (:mod:`i2v_tpu_torch.models.mvit`), all
three in one launch, read straight from the qkv Linear's output: each
keeps its class token, has its (T, H, W) grid pooled by its depthwise 3³
conv and every row normalised by its LayerNorm, written in the layout that
``launch_pool_attn`` reads. Forward only. Replaces no Pallas kernel: the JAX
package has no MViT. The CUDA kernel is ``csrc/pool_qkv.cu``; it computes in
float32 on the CUDA cores, and counts in ``launches["pool_qkv"]`` as
``pool_attn`` does.

``launch_dwconv3d(x, thw, weight, bias, residual)`` — UniFormer's depthwise
3-D convs (:mod:`i2v_tpu_torch.models.uniformer`): ``(x +) bias + Σ w·x``
over k³ taps (k 3 or 5, stride 1, zero padding k // 2) of a token-major
(clips, T·H·W, C) grid, written in the same layout, forward only: the DPE of
every block with its residual, and the conv blocks' 5³ local affinity.
Replaces no Pallas kernel: the JAX package has no UniFormer. The CUDA kernel
is ``csrc/dwconv3d.cu``; it computes in float32 on the CUDA cores, and counts
in ``launches["dwconv3d"]`` as ``pool_attn`` does.

``launch_global_attn(q, k, v)`` — UniFormer's global attention
(:mod:`i2v_tpu_torch.models.uniformer`), ``softmax(q·kᵀ·64^-0.5)·v`` of every
(clip, head) at head dimension 64 in one launch, forward only, q, k and v read
by strides where they lie (the qkv Linear's output), into the projection's
layout. Replaces no Pallas kernel: the JAX package has no UniFormer. The CUDA
kernel is ``csrc/global_attn.cu``, the port's first on the tensor cores: its
float32 products go through three TF32 products each (3xTF32), float32-accurate
whatever PyTorch's TF32 flags say. It counts in ``launches["global_attn"]`` as
``pool_attn`` does.

Each source is built with ``nvcc`` for sm_90a at first use (:mod:`._build`).
The first four kernels are elementwise and bound by device-memory bytes (12,
16, 16, and 8 or 12 bytes an element); each makes one pass with 16-byte
vector accesses where the shapes and pointers allow; window and pooling
attention are bound by float32 arithmetic, the pooling of q, k and v by
bytes, the depthwise convs by bytes at k = 3 and by arithmetic at k = 5, the
global attention by the tensor cores' TF32 rate over three products; the
sources say more.

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
import math
import threading

import numpy as np
import torch

from . import _build, pixel

launches = {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": 0, "bias_act": 0,
            "window_attn": 0, "pool_attn": 0, "pool_qkv": 0, "dwconv3d": 0, "global_attn": 0}
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


_PTR, _N, _F32, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
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
    "bias_act": {
        "bias_act": [_PTR, _PTR, _PTR, _N, _N, _I, _I, _I, _PTR],
    },
    "window_attn": {
        "window_attn_fwd": [_PTR, _PTR, _PTR, _N] + [_I] * 13 + [_F32, _I, _PTR],
    },
    "pool_attn": {
        "pool_attn_fwd": [_PTR] * 7 + [_N] + [_I] * 6 + [_F32, _PTR],
    },
    "pool_qkv": {
        "pool_qkv_fwd": [_PTR] * 13 + [_N] + [_I] * 10 + [_F32, _I, _PTR],
    },
    "dwconv3d": {
        "dwconv3d_fwd": [_PTR] * 4 + [_N] + [_I] * 7 + [_PTR],
    },
    "global_attn": {
        "global_attn_fwd": [_PTR] * 4 + [_N, _I, _I, _N, _N, _N, _I, _PTR],
    },
}


def _load(name: str) -> _build.BuiltLibrary:
    """Build ``csrc/{name}.cu`` (unless built already) and load it."""
    lib = _build.build(name)
    for fn, argtypes in SOURCES[name].items():
        getattr(lib.cdll, fn).argtypes = argtypes
        getattr(lib.cdll, fn).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def build_all() -> dict[str, _build.BuiltLibrary]:
    """Build every kernel source at once, one ``nvcc`` each, in parallel,
    and load them (once per process)."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(_load, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


def library(name: str) -> _build.BuiltLibrary:
    """``csrc/{name}.cu``, loaded: the first kernel a process launches
    builds them all, in parallel."""
    return build_all()[name]


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


# the dtypes bias_act's kernel takes, and the code its C entry point reads
BIAS_ACT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch_bias_act(y: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None = None,
                    relu: bool = True) -> torch.Tensor:
    """``y = act(y + bias[c] (+ residual))`` in place on the card; returns ``y``."""
    name = "bias_act"
    tensors = [y, bias] + ([] if residual is None else [residual])
    if y.dtype not in BIAS_ACT_DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {y.dtype}")
    if any(t.dtype != y.dtype for t in tensors):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in tensors]} differ")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if y.dim() < 2 or bias.shape != (y.shape[1],):
        raise ValueError(f"{name}: y {tuple(y.shape)} needs a bias of shape (C,), "
                         f"got {tuple(bias.shape)}")
    if residual is not None and residual.shape != y.shape:
        raise ValueError(f"{name}: residual {tuple(residual.shape)} is not y's "
                         f"{tuple(y.shape)}")
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got one on {t.device}")
        if t.device != y.device:
            raise ValueError(f"{name}: tensors on {t.device} and {y.device}")
    planes = y.shape[0] * y.shape[1]
    if planes >= 2**31:
        raise ValueError(f"{name}: {planes} planes; the kernel's grid takes fewer than 2^31")
    with torch.cuda.device(y.device):
        err = library(name).cdll.bias_act(
            y.data_ptr(), bias.data_ptr(), None if residual is None else residual.data_ptr(),
            planes, math.prod(y.shape[2:]), y.shape[1], BIAS_ACT_DTYPES[y.dtype], int(relu),
            _stream(y))
    _raise_on(err, name)
    count_launch(name)
    return y


class BiasAct(torch.autograd.Function):
    """``act(y + bias[c] (+ residual))`` in place on ``y``: the kernel on the
    card, the plain version elsewhere. The backward is autograd's own for
    ``relu`` (``threshold_backward`` against the output), or, with a
    ``relu_grad_scale`` other than 1, SGM's ``g·scale·[out > 0]``
    (:class:`~i2v_tpu_torch.ops.activations.GradScaledReLU`'s expression:
    ``out > 0`` where its input is), handed to ``y`` and to ``residual`` as
    an add hands it, and summed over every axis but the channels for
    ``bias``; built of differentiable ops, so a double backward (Grad-CAM's)
    goes through it."""

    @staticmethod
    def forward(ctx, y, bias, residual, relu, relu_grad_scale):
        if y.is_cuda:
            launch_bias_act(y, bias, residual, relu)
        else:
            pixel.bias_act(y, bias, residual, relu)
        ctx.mark_dirty(y)
        ctx.relu, ctx.scale, ctx.has_residual = relu, relu_grad_scale, residual is not None
        if relu:
            ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        if ctx.relu:
            (out,) = ctx.saved_tensors
            if ctx.scale == 1.0:
                grad = torch.ops.aten.threshold_backward(grad, out, 0)
            else:
                grad = grad * ctx.scale * (out > 0).to(grad.dtype)
        dbias = None
        if ctx.needs_input_grad[1]:
            dbias = grad.sum([0] + list(range(2, grad.dim())))
        return grad, dbias, grad if ctx.has_residual else None, None, None


def bias_act(y: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None = None,
             relu: bool = True, relu_grad_scale: float = 1.0) -> torch.Tensor:
    """Differentiable ``act(y + bias[c] (+ residual))``, in place on ``y``
    (which must not be a leaf that requires a gradient), returned; the ReLU's
    backward scaled by ``relu_grad_scale`` (SGM) unless it is 1."""
    return BiasAct.apply(y, bias, residual, relu, relu_grad_scale)


# the dtypes window attention's kernel takes, and the code its C entry point reads
WINDOW_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WINDOW_ATTN_HEAD_DIM = 32
WINDOW_ATTN_MAX_TOKENS = 392


def launch_window_attn(qkv: torch.Tensor, table: torch.Tensor, *, window, full_window, shift,
                       counts) -> torch.Tensor:
    """``softmax(q·hd^-0.5·kᵀ + table[index[:N, :N]] (+ mask))·v`` of every
    (window, head) on the card: qkv (windows, N, 3, heads, 32), the windows
    of each clip in (D, H, W) order, ``counts`` of them along each axis;
    ``window`` and ``shift`` the used ones, ``full_window`` the configured
    one, whose relative index reads ``table`` (rows, heads), float32. →
    (windows, N, heads·32) in qkv's dtype."""
    name = "window_attn"
    if qkv.dtype not in WINDOW_ATTN_DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {qkv.dtype}")
    if table.dtype != torch.float32:
        raise TypeError(f"{name}: the bias table must be float32, got {table.dtype}")
    if not (qkv.is_cuda and table.is_cuda) or qkv.device != table.device:
        raise ValueError(f"{name}: expected CUDA tensors on one card, got {qkv.device} "
                         f"and {table.device}")
    if not (qkv.is_contiguous() and table.is_contiguous()) or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes contiguous, 16-byte aligned tensors")
    if qkv.dim() != 5 or qkv.shape[2] != 3 or qkv.shape[4] != WINDOW_ATTN_HEAD_DIM:
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} is not (windows, N, 3, heads, "
                         f"{WINDOW_ATTN_HEAD_DIM})")
    windows, n, _, heads, hd = qkv.shape
    if n != math.prod(window) or n > WINDOW_ATTN_MAX_TOKENS:
        raise ValueError(f"{name}: N = {n} is not the window {tuple(window)}'s tokens, or "
                         f"over {WINDOW_ATTN_MAX_TOKENS}")
    if any(w > f for w, f in zip(window, full_window)) or windows % math.prod(counts):
        raise ValueError(f"{name}: window {tuple(window)} past {tuple(full_window)}, or "
                         f"{windows} windows not whole clips of {tuple(counts)}")
    if table.shape != (math.prod(2 * f - 1 for f in full_window), heads):
        raise ValueError(f"{name}: table {tuple(table.shape)} is not the ({full_window}) "
                         f"window's rows by {heads} heads")
    out = torch.empty(windows, n, heads * hd, dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = library(name).cdll.window_attn_fwd(
            qkv.data_ptr(), table.data_ptr(), out.data_ptr(), windows, heads, *counts,
            *window, *shift, *full_window, float(np.float32(hd ** -0.5)),
            WINDOW_ATTN_DTYPES[qkv.dtype], _stream(qkv))
    _raise_on(err, name)
    count_launch(name)
    return out


POOL_ATTN_HEAD_DIM = 96
# kt + kh + kw: the rows of relative terms that a block keeps in shared memory
POOL_ATTN_MAX_TERMS = 45


def launch_pool_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_t: torch.Tensor,
                     rel_h: torch.Tensor, rel_w: torch.Tensor) -> torch.Tensor:
    """``softmax(q·hd^-0.5·kᵀ + B)·v + q`` (the residual at rows ≥ 1) of
    every (clip, head) on the card: q (clips, heads, 1 + Nq, 96), k and v
    (clips, heads, 1 + Nk, 96), row and key 0 the class token; ``B[i, j] =
    rel_t[i, t] + rel_h[i, h] + rel_w[i, w]`` for spatial query i and key j
    at (t, h, w) of the (kt, kh, kw) key grid, 0 on the class token's row and
    column; the terms (clips·heads, Nq, kt | kh | kw), their widths the key
    grid. All float32. → (clips, 1 + Nq, heads·96)."""
    name = "pool_attn"
    tensors = (q, k, v, rel_t, rel_h, rel_w)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: the kernel takes float32, got {[t.dtype for t in tensors]}")
    if not all(t.is_cuda for t in tensors) or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: expected CUDA tensors on one card, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors) or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: the kernel takes contiguous tensors, q, k and v 16-byte "
                         "aligned")
    if q.dim() != 4 or q.shape[3] != POOL_ATTN_HEAD_DIM or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != POOL_ATTN_HEAD_DIM \
            or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not (clips, heads, N, {POOL_ATTN_HEAD_DIM}) "
                         "of one clips and heads")
    clips, heads, nq1, _ = q.shape
    nk1 = k.shape[2]
    grid = tuple(t.shape[-1] for t in (rel_t, rel_h, rel_w))
    if any(t.shape[:2] != (clips * heads, nq1 - 1) or t.dim() != 3 for t in tensors[3:]):
        raise ValueError(f"{name}: terms {[tuple(t.shape) for t in tensors[3:]]} are not "
                         f"({clips * heads}, {nq1 - 1}, key grid axis)")
    if nq1 < 1 or nk1 != 1 + math.prod(grid) or sum(grid) > POOL_ATTN_MAX_TERMS:
        raise ValueError(f"{name}: {nk1} keys are not 1 + the key grid {grid}, or its axes "
                         f"sum past {POOL_ATTN_MAX_TERMS}")
    out = torch.empty(clips, nq1, heads * POOL_ATTN_HEAD_DIM, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = library(name).cdll.pool_attn_fwd(
            *(t.data_ptr() for t in tensors), out.data_ptr(), clips, heads, nq1, nk1, *grid,
            float(np.float32(POOL_ATTN_HEAD_DIM ** -0.5)), _stream(q))
    _raise_on(err, name)
    count_launch(name)
    return out


# the dtypes the q, k and v pooling kernel takes, and the code its C entry point reads
POOL_QKV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
POOL_QKV_HEAD_DIM = 96


def launch_pool_qkv(qkv: torch.Tensor, thw, stride_q, stride_kv, weights, norms,
                    eps: float) -> tuple:
    """q, k and v of MViTv2's pooling attention on the card, in one launch:
    qkv (clips, 1 + T·H·W, 3, heads, 96), float32 or bfloat16, token 0 the
    class token, the others the (T, H, W) grid ``thw``; for q (stride
    ``stride_q``), k and v (``stride_kv``) the class token kept, the grid
    pooled by the tensor's depthwise 3³ conv (``weights``, three (96, 1, 3,
    3, 3) in qkv's dtype, zero padding 1; in bfloat16 the pooled value
    rounded to it) and every row normalised over its 96 channels by its
    LayerNorm (``norms``, three (weight, bias) pairs of (96,) float32, ε
    ``eps``). → (q, k, v, q grid, k grid): q (clips, heads, 1 + Nq, 96), k
    and v (clips, heads, 1 + Nk, 96), float32."""
    name = "pool_qkv"
    hd = POOL_QKV_HEAD_DIM
    params = [p for pair in norms for p in pair]
    if qkv.dtype not in POOL_QKV_DTYPES or any(w.dtype != qkv.dtype for w in weights):
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16 qkv and conv weights of "
                        f"its dtype, got {qkv.dtype} and {[w.dtype for w in weights]}")
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError(f"{name}: the norms' weights and biases must be float32, got "
                        f"{[p.dtype for p in params]}")
    tensors = (qkv, *weights, *params)
    if not all(t.is_contiguous() for t in tensors) or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes contiguous tensors, qkv 16-byte aligned")
    strides = (tuple(stride_q), tuple(stride_kv))
    if len(weights) != 3 or len(norms) != 3 or len(thw) != 3 \
            or any(len(s) != 3 or min(s) < 1 for s in strides):
        raise ValueError(f"{name}: three weights, norms and strides of (T, H, W), got "
                         f"{len(weights)}, {len(norms)} and {strides} over {tuple(thw)}")
    if qkv.dim() != 5 or qkv.shape[1] != 1 + math.prod(thw) or qkv.shape[2] != 3 \
            or qkv.shape[4] != hd:
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} is not (clips, 1 + T·H·W, 3, heads, "
                         f"{hd}) over the grid {tuple(thw)}")
    if any(tuple(w.shape) != (hd, 1, 3, 3, 3) for w in weights) \
            or any(tuple(p.shape) != (hd,) for p in params):
        raise ValueError(f"{name}: weights {[tuple(w.shape) for w in weights]} are not "
                         f"({hd}, 1, 3, 3, 3), or norms {[tuple(p.shape) for p in params]} not "
                         f"({hd},)")
    if not all(t.is_cuda for t in tensors) or any(t.device != qkv.device for t in tensors):
        raise ValueError(f"{name}: expected CUDA tensors on one card, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    clips, heads = qkv.shape[0], qkv.shape[3]
    grids = [tuple((n - 1) // s + 1 for n, s in zip(thw, st)) for st in strides]
    outs = [torch.empty(clips, heads, 1 + math.prod(g), hd, dtype=torch.float32,
                        device=qkv.device) for g in (grids[0], grids[1], grids[1])]
    with torch.cuda.device(qkv.device):
        err = library(name).cdll.pool_qkv_fwd(
            qkv.data_ptr(), *(t.data_ptr() for t in (*weights, *params, *outs)), clips, heads,
            *thw, *strides[0], *strides[1], float(eps), POOL_QKV_DTYPES[qkv.dtype],
            _stream(qkv))
    _raise_on(err, name)
    count_launch(name)
    return (*outs, *grids)


# the dtypes the depthwise conv kernel takes, and the code its C entry point reads
DWCONV3D_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DWCONV3D_KERNELS = (3, 5)
DWCONV3D_CHANNELS = 32   # C is a whole number of the kernel's 32-channel slices


def launch_dwconv3d(x: torch.Tensor, thw, weight: torch.Tensor, bias: torch.Tensor,
                    residual: bool) -> torch.Tensor:
    """UniFormer's depthwise 3-D conv on the card: x (clips, T·H·W, C),
    float32 or bfloat16, the tokens of the (T, H, W) grid ``thw`` in
    row-major order; ``weight`` (C, 1, k, k, k) and ``bias`` (C,) in x's
    dtype, k 3 or 5; stride 1, zero padding k // 2. → ``(x +) bias + conv``
    in x's shape and dtype, x added where ``residual`` (the DPE)."""
    name = "dwconv3d"
    tensors = (x, weight, bias)
    if x.dtype not in DWCONV3D_DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16 and weights of its "
                        f"dtype, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors) or x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes contiguous tensors, x 16-byte aligned")
    if len(thw) != 3 or x.dim() != 3 or x.shape[1] != math.prod(thw):
        raise ValueError(f"{name}: x {tuple(x.shape)} is not (clips, T·H·W, C) over the grid "
                         f"{tuple(thw)}")
    c, k = x.shape[2], weight.shape[-1]
    if c % DWCONV3D_CHANNELS or k not in DWCONV3D_KERNELS \
            or tuple(weight.shape) != (c, 1, k, k, k) or tuple(bias.shape) != (c,):
        raise ValueError(f"{name}: C = {c} must be a multiple of {DWCONV3D_CHANNELS}, the "
                         f"weight (C, 1, k, k, k) with k in {DWCONV3D_KERNELS} and the bias "
                         f"(C,); got {tuple(weight.shape)} and {tuple(bias.shape)}")
    if not all(t.is_cuda for t in tensors) or any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: expected CUDA tensors on one card, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = library(name).cdll.dwconv3d_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), x.shape[0],
            *thw, c, k, int(residual), DWCONV3D_DTYPES[x.dtype], _stream(x))
    _raise_on(err, name)
    count_launch(name)
    return out


# the dtypes the global attention kernel takes, and the code its C entry point reads
GLOBAL_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GLOBAL_ATTN_HEAD_DIM = 64


def launch_global_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q·kᵀ·64^-0.5)·v`` of every (clip, head) on the card: q, k
    and v (clips, heads, N, 64) of one dtype, float32 or bfloat16, read where
    they lie: one set of strides, the last 1, every row 16-byte aligned (the
    qkv Linear's output (clips, N, 3·heads·64) viewed as (clips, N, 3, heads,
    64) and permuted takes no copy). → (clips, N, heads·64) in their dtype."""
    name = "global_attn"
    tensors = (q, k, v)
    if q.dtype not in GLOBAL_ATTN_DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16 q, k and v of one dtype, "
                        f"got {[t.dtype for t in tensors]}")
    if q.dim() != 4 or q.shape[3] != GLOBAL_ATTN_HEAD_DIM or q.shape[2] < 1 \
            or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not one (clips, heads, N, "
                         f"{GLOBAL_ATTN_HEAD_DIM}) with N >= 1")
    if any(t.stride() != q.stride() for t in tensors) or q.stride(3) != 1:
        raise ValueError(f"{name}: q, k and v must share their strides, the last 1; got "
                         f"{[t.stride() for t in tensors]}")
    per_16 = 16 // q.element_size()
    if any(s % per_16 for s in q.stride()[:3]) or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every row of q, k and v must be 16-byte aligned; strides "
                         f"{q.stride()}, offsets {[t.data_ptr() % 16 for t in tensors]}")
    if not all(t.is_cuda for t in tensors) or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: expected CUDA tensors on one card, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    clips, heads, n, hd = q.shape
    out = torch.empty(clips, n, heads * hd, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = library(name).cdll.global_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), clips, heads, n,
            *q.stride()[:3], GLOBAL_ATTN_DTYPES[q.dtype], _stream(q))
    _raise_on(err, name)
    count_launch(name)
    return out
