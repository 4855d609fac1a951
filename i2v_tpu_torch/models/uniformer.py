"""UniFormer-B 32×4 on Kinetics-400 (Li et al., "UniFormer: Unified
Transformer for Efficient Spatiotemporal Representation Learning", ICLR
2022; arXiv:2201.04676), Sense-X's ``uniformer_base``
(``github.com/Sense-X/UniFormer``, ``video_classification/slowfast/models/
uniformer.py``): four stages of depths (5, 8, 20, 7) at widths (64, 128,
320, 512), heads of 64 (1, 2, 5 and 8 heads), MLP ratio 4, qkv bias; stages
1–2 are conv blocks (``CBlock``) and stages 3–4 attention blocks
(``SABlock``). The published code is followed equation for equation:

  - patch embeddings: Conv3d(3 → 64) kernel (3,4,4) stride (2,4,4) padding
    (1,0,0) (``SpeicalPatchEmbed``), then Conv3d kernel = stride (1,2,2)
    before stages 2–4 (``PatchEmbed``, ``std`` false), each followed by a
    LayerNorm over the channels (``nn.LayerNorm``'s ε 1e-5);
  - ``CBlock``: ``x = x + dpe(x)`` (depthwise Conv3d 3³, padding 1, bias);
    ``x = x + conv2(dw5(conv1(bn1(x))))`` (1×1×1 convs around a depthwise
    5³, padding 2, all with bias); ``x = x + fc2(gelu(fc1(bn2(x))))``;
  - ``SABlock``: the same DPE; then over the tokens (T·H·W row-major)
    ``t = t + proj(attn(ln1(t)))``, ``softmax(q·kᵀ·64^-0.5)·v`` over every
    token of the clip, and ``t = t + fc2(gelu(fc1(ln2(t))))``, LayerNorm ε
    1e-6, GELU exact (erf);
  - head: BatchNorm3d, the mean over T·H·W, ``Linear(512 → 400)``.

Inside, every stage is token-major, ``(B, T·H·W, C)``: the 1×1×1 convs
are linears (cuBLAS) and no NCDHW permute runs between blocks. Taps
``stage{i}`` are the outputs of stage ``i``'s last block, NCDHW views like
the other video models' taps. ``truncate`` with taps builds and runs no
stage past the deepest tap's and no head.

BatchNorm is eval-mode, held as a frozen per-channel affine
(:class:`FrozenBatchNorm`: weight γ/√(σ²+ε), bias β − μ·γ/√(σ²+ε),
:func:`.convert.convert_uniformer` reduces the published statistics to it),
and folded into the linear that follows it at each forward
(:func:`folded_linear`): exact in arithmetic, since no 1×1×1 conv pads.

The depthwise convs, 53 a forward (a DPE a block and the 13 conv blocks'
5³), are one hand-written kernel on a card
(:func:`~i2v_tpu_torch.ops.kernels.launch_dwconv3d`, reading and writing
the token-major grid, the DPE's residual fused; forward only: under autograd
on a card it raises) and :func:`dwconv3d_plain`, the grouped ``F.conv3d``,
elsewhere, which is the kernel's oracle. The global attention of stages
3–4 is one hand-written kernel on a card too
(:func:`~i2v_tpu_torch.ops.kernels.launch_global_attn`: float32 products
through three TF32 products on the tensor cores, q, k and v read from the
qkv Linear's output as it lies, the output in the projection's layout, the
(tokens × tokens) scores never in device memory; forward only), and
:func:`global_attention_plain` elsewhere, the kernel's oracle.

Compute ``dtype`` (:mod:`.common`): convs and linears compute in it; the
LayerNorms give the promoted dtype of their input and float32 parameters
(ViT's rule) and the folds are made in float32 and cast to the linear's
dtype; the logits come back as float32. ``relu_grad_scale`` (SGM) has no
ReLU to scale here."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import kernels
from .common import Conv3d, Linear, deepest, set_compute_dtype
from .video_common import remat_call, to_compute
from .vit import LayerNorm

# Sense-X's uniformer_base, keyed as the benchmark's configuration file keys it
UNIFORMER_B = {
    "frames": 32, "hw": 224, "classes": 400, "depth": [5, 8, 20, 7],
    "embed_dim": [64, 128, 320, 512], "head_dim": 64, "mlp_ratio": 4.0, "conv_stages": 2,
    "patch_kernel": [3, 4, 4], "patch_stride": [2, 4, 4], "patch_padding": [1, 0, 0],
    "merge_kernel": [1, 2, 2], "dpe_kernel": 3, "local_kernel": 5,
    "layer_norm_eps": 1e-6, "patch_norm_eps": 1e-5, "batch_norm_eps": 1e-5,
}
# the test variant: every mechanism (a conv stage, an attention stage of two
# and one of three heads, both DPEs, the 5³ affinity, four patch
# embeddings), widths that the kernel's 32-channel slices divide, at 8 x 64^2
# (grids 4x16x16 to 4x2x2); 10 classes
TINY = dict(UNIFORMER_B, frames=8, hw=64, classes=10, depth=[1, 1, 2, 1],
            embed_dim=[32, 64, 128, 192])


class FrozenBatchNorm(nn.Module):
    """An eval-mode BatchNorm3d as its per-channel affine: ``weight`` the
    scale γ/√(σ²+ε), ``bias`` the shift β − μ·γ/√(σ²+ε). Float32, never
    cast to the compute dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def folded_linear(x: torch.Tensor, norm: FrozenBatchNorm, linear: nn.Linear) -> torch.Tensor:
    """``linear(x·s + b)`` for the affine (s, b) of ``norm`` over the last
    axis, as one linear: W·diag(s) and W·b + bias, made in float32 and cast
    to the linear's dtype."""
    w = linear.weight.float()
    weight = (w * norm.weight.float()).to(linear.weight.dtype)
    bias = torch.addmv(linear.bias.float(), w, norm.bias.float()).to(linear.weight.dtype)
    return F.linear(x.to(weight.dtype), weight, bias)


def dwconv3d_plain(x: torch.Tensor, thw: Sequence[int], conv: nn.Conv3d,
                   residual: bool) -> torch.Tensor:
    """``(x +) conv(x)`` of a depthwise Conv3d over the token-major grid x
    (B, T·H·W, C), through the grouped ``F.conv3d`` on an NCDHW view:
    the kernel's oracle and the path off the card."""
    b, _, c = x.shape
    y = conv(x.transpose(1, 2).reshape(b, c, *thw)).flatten(2).transpose(1, 2)
    return x + y if residual else y


def dwconv3d(x: torch.Tensor, thw: Sequence[int], conv: nn.Conv3d,
             residual: bool) -> torch.Tensor:
    """The kernel on a card, :func:`dwconv3d_plain` elsewhere."""
    if x.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, conv.weight, conv.bias)):
            raise RuntimeError("the depthwise convs on a card are forward only: their kernel has "
                               "no backward")
        return kernels.launch_dwconv3d(x.to(conv.weight.dtype).contiguous(), thw, conv.weight,
                                       conv.bias, residual)
    return dwconv3d_plain(x, thw, conv, residual)


def global_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q·kᵀ·hd^-0.5)·v`` of every (clip, head), scores
    materialised, as the published ``Attention`` computes it."""
    attn = (q @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5
    return attn.softmax(dim=-1) @ v


def global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q·kᵀ·hd^-0.5)·v`` of q, k and v (B, heads, N, hd) →
    (B, N, heads·hd), the projection's layout: the kernel on a card (read
    where q, k and v lie; forward only), :func:`global_attention_plain`
    elsewhere."""
    if q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise RuntimeError("the global attention on a card is forward only: its kernel has "
                               "no backward")
        return kernels.launch_global_attn(q, k, v)
    b, heads, n, hd = q.shape
    return global_attention_plain(q, k, v).transpose(1, 2).reshape(b, n, heads * hd)


def patch_merge(x: torch.Tensor, thw: Sequence[int], proj: nn.Conv3d) -> tuple:
    """A (1,2,2) Conv3d of kernel = stride over the token-major grid, as a
    linear over each 2×2 patch's gathered tokens (floor mode: a trailing odd
    row or column is dropped) → (tokens, grid)."""
    b, _, c = x.shape
    t, h, w = thw
    h2, w2 = h // 2, w // 2
    x = x.view(b, t, h, w, c)[:, :, :2 * h2, :2 * w2]
    x = x.reshape(b, t, h2, 2, w2, 2, c).permute(0, 1, 2, 4, 3, 5, 6).reshape(b, -1, 4 * c)
    weight = proj.weight.permute(0, 2, 3, 4, 1).reshape(proj.out_channels, 4 * c)
    return F.linear(x.to(weight.dtype), weight, proj.bias), (t, h2, w2)


class PatchEmbed(nn.Module):
    """``proj`` (a Conv3d) then ``norm`` over the channels; the first one
    (``first``) runs on the NCDHW clip, the others merge 2×2 patches of the
    token-major grid."""

    def __init__(self, in_dim: int, dim: int, spec: dict, first: bool):
        super().__init__()
        self.first = first
        if first:
            self.proj = Conv3d(in_dim, dim, tuple(spec["patch_kernel"]),
                               stride=tuple(spec["patch_stride"]),
                               padding=tuple(spec["patch_padding"]))
        else:
            kernel = tuple(spec["merge_kernel"])
            self.proj = Conv3d(in_dim, dim, kernel, stride=kernel)
        self.norm = LayerNorm(dim, eps=spec["patch_norm_eps"])

    def forward(self, x: torch.Tensor, thw: Sequence[int] | None = None) -> tuple:
        if self.first:
            x = self.proj(x)
            thw = tuple(x.shape[2:])
            x = x.flatten(2).transpose(1, 2)
        else:
            x, thw = patch_merge(x, thw, self.proj)
        return self.norm(x), thw


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def depthwise(dim: int, kernel: int) -> nn.Conv3d:
    return Conv3d(dim, dim, (kernel,) * 3, padding=kernel // 2, groups=dim)


class CBlock(nn.Module):
    """The conv block; ``conv1``, ``conv2`` and the MLP's ``fc1``, ``fc2``
    are the published 1×1×1 convs as linears."""

    def __init__(self, dim: int, spec: dict):
        super().__init__()
        self.pos_embed = depthwise(dim, spec["dpe_kernel"])
        self.norm1 = FrozenBatchNorm(dim)
        self.conv1 = Linear(dim, dim)
        self.conv2 = Linear(dim, dim)
        self.attn = depthwise(dim, spec["local_kernel"])
        self.norm2 = FrozenBatchNorm(dim)
        self.mlp = Mlp(dim, int(dim * spec["mlp_ratio"]))

    def forward(self, x: torch.Tensor, thw: Sequence[int]) -> torch.Tensor:
        x = dwconv3d(x, thw, self.pos_embed, residual=True)
        a = dwconv3d(folded_linear(x, self.norm1, self.conv1), thw, self.attn, residual=False)
        x = x + self.conv2(a)
        return x + self.mlp.fc2(F.gelu(folded_linear(x, self.norm2, self.mlp.fc1)))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        return self.proj(global_attention(q, k, v))


class SABlock(nn.Module):
    def __init__(self, dim: int, spec: dict):
        super().__init__()
        eps = spec["layer_norm_eps"]
        self.pos_embed = depthwise(dim, spec["dpe_kernel"])
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, dim // spec["head_dim"])
        self.norm2 = LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * spec["mlp_ratio"]))

    def forward(self, x: torch.Tensor, thw: Sequence[int]) -> torch.Tensor:
        x = dwconv3d(x, thw, self.pos_embed, residual=True)
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class UniFormer(nn.Module):
    """``spec`` holds the published settings (:data:`UNIFORMER_B`'s keys);
    ``taps`` are ``stage{i}`` (1-based); ``truncate`` builds and runs no
    stage past the deepest tap's and no head; ``remat`` recomputes each
    block in the backward pass (off the card: the kernels have no backward)."""

    def __init__(self, spec: dict, num_classes: int | None = None, remat: bool = False,
                 taps: Sequence[str] = (), truncate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        dims = spec["embed_dim"]
        self.n_stages = deepest([int(k[len("stage"):]) for k in taps], truncate, len(dims))
        self.headless = truncate and bool(taps)
        for s in range(self.n_stages):
            setattr(self, f"patch_embed{s + 1}",
                    PatchEmbed(dims[s - 1] if s else 3, dims[s], spec, first=s == 0))
            block = CBlock if s < spec["conv_stages"] else SABlock
            setattr(self, f"blocks{s + 1}",
                    nn.ModuleList(block(dims[s], spec) for _ in range(spec["depth"][s])))
        if not self.headless:
            self.norm = FrozenBatchNorm(dims[-1])
            self.head = Linear(dims[-1], num_classes or spec["classes"])
        set_compute_dtype(self, dtype)

    def forward(self, clip_bcthw: torch.Tensor, *, normalize: bool = True,
                relu_grad_scale: float = 1.0):
        """→ (logits or None, {"stage1": …, …}); ``normalize`` applies
        ImageNet normalization to a [0,1] clip (off for a normalized one)."""
        x, thw = to_compute(clip_bcthw, normalize, self.dtype), None
        taps = {}
        for s in range(self.n_stages):
            x, thw = getattr(self, f"patch_embed{s + 1}")(x, thw)
            for block in getattr(self, f"blocks{s + 1}"):
                x = remat_call(self.remat, block, x, thw)
            taps[f"stage{s + 1}"] = x.transpose(1, 2).unflatten(2, thw)
        if self.headless:
            return None, taps
        # the BatchNorm commutes with the mean over the tokens
        return folded_linear(x.float().mean(1), self.norm, self.head).float(), taps


def uniformer_b(num_classes: int | None = None, **kw) -> UniFormer:
    return UniFormer(UNIFORMER_B, num_classes, **kw)


def uniformer_tiny(num_classes: int | None = None, **kw) -> UniFormer:
    """:data:`TINY`: four stages of one or two blocks at 8 x 64^2, 10 classes."""
    return UniFormer(TINY, num_classes, **kw)
