"""MViTv2-B 32×3 on Kinetics-400 (Li et al., "MViTv2: Improved Multiscale
Vision Transformers for Classification and Detection", CVPR 2022;
arXiv:2112.01526), PySlowFast's ``configs/Kinetics/MVITv2_B_32x3.yaml``:
24 blocks from width 96 and one head, width and heads doubled at blocks 2,
5 and 21 (stages of 2, 3, 16 and 3 blocks at 96/192/384/768 with 1/2/4/8
heads of 96), patch (3,7,7) stride (2,4,4) padding (1,3,3), pooling
kernel (3,3,3), a query stride (1,2,2) at blocks 2, 5 and 21 and an
adaptive key/value stride that starts at (1,8,8), MLP ratio 4, qkv bias,
LayerNorm ε 1e-6, a class token and no absolute position embedding. The
published code (``MViT`` and ``MultiScaleBlock`` of
``github.com/facebookresearch/SlowFast``, ``MODE: conv``,
``REL_POS_SPATIAL``, ``REL_POS_TEMPORAL``, ``RESIDUAL_POOLING``,
``DIM_MUL_IN_ATT``) is followed equation for equation:

  - patch embedding: Conv3d(3 → 96), flattened over (T, H, W) row-major,
    the class token prepended;
  - block (``dim → dim_out``): ``xn = norm1(x)``; ``a = attn(xn)``; the
    skip is ``proj(xn)`` where the width changes, else ``x``, max-pooled
    (kernel (1,3,3), stride (1,2,2), padding (0,1,1), the class token kept
    aside) where the block strides its queries; ``x = skip + a``;
    ``x = x + mlp(norm2(x))``, GELU exact (erf);
  - attention: ``qkv`` over every token, split into heads of 96; each of q,
    k and v has its class token split off, its (T, H, W) grid pooled by a
    depthwise Conv3d (kernel 3³, padding 1, no bias, shared by the heads;
    stride ``stride_q`` for q, ``stride_kv`` for k and v), the class token
    joined back, then a LayerNorm over the head dim; scores
    ``(q·hd^-0.5)·kᵀ``, plus on the spatial rows and columns the decomposed
    relative positions ``rel_t + rel_h + rel_w``, each a product of the
    **unscaled** pooled q with a per-block table read through stride-aware
    distances (``cal_rel_pos_spatial``, ``cal_rel_pos_temporal``; a table
    whose rows do not match ``2·max(q, k) − 1`` is resized linearly, as
    ``get_rel_pos`` does); softmax; ``·v``; plus the pooled q at every token
    but the class token (residual pooling); ``proj``;
  - the key/value stride of each block is ``max(stride_kv // stride_q, 1)``
    of the block before, per axis, from (1,8,8) (``POOL_KV_STRIDE_ADAPTIVE``);
  - head: the final LayerNorm, the class token, ``Linear(768 → 400)``. The
    published head applies a softmax at test time; the module returns the
    Linear's output, whose argmax is the same.

Inside, tokens are ``(B, 1 + T·H·W, C)``; taps ``stage{i}`` are the outputs
of stage ``i``'s last block without the class token, NCDHW views like the
other video models' taps. ``truncate`` with taps builds and runs no block
past the deepest tap's stage and no head.

The pooling of q, k and v, each with its LayerNorm, is one hand-written
kernel a block on a card (:func:`~i2v_tpu_torch.ops.kernels.launch_pool_qkv`,
read straight from the qkv Linear's output, forward only) and
:func:`pool_qkv_plain` (three :func:`attention_pool` calls) elsewhere, which
is the kernel's oracle; the skip's max-pool goes through
:func:`attention_pool` on both. The attention's core, ``softmax(q·scale·kᵀ
+ B)·v + q`` of every (clip, head), is one hand-written kernel on a card
(:func:`~i2v_tpu_torch.ops.kernels.launch_pool_attn`, forward only: under
autograd on a card it raises) and :func:`pool_attention_plain` elsewhere,
which is the kernel's oracle. Both take the three per-query relative terms
(:func:`relative_terms`, small products before the launch); neither path on
the card materialises the (queries × keys) scores. The module holds no
buffer: the distance indices are cached per (sizes, device) outside the
state dict.

Compute ``dtype`` (:mod:`.common`): convs and linears compute in it; the
LayerNorms give the promoted dtype of their input and float32 parameters
(ViT's rule), so pooled q, k and v and everything the attention computes are
float32, and the logits come back as float32. ``relu_grad_scale`` (SGM) has
no ReLU to scale here."""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import kernels
from .common import Conv3d, Linear, deepest, set_compute_dtype
from .video_common import cached_tensors, max_pool3d, remat_call, to_compute
from .vit import LayerNorm

LN_EPS = 1e-6

# MViTv2-B 32x3 (PySlowFast's MVITv2_B_32x3.yaml), keyed as the
# benchmark's configuration file keys it
MVIT_V2_B = {
    "frames": 32, "hw": 224, "classes": 400, "depth": 24, "embed_dim": 96, "num_heads": 1,
    "dim_mul": [[2, 2.0], [5, 2.0], [21, 2.0]], "head_mul": [[2, 2.0], [5, 2.0], [21, 2.0]],
    "patch_kernel": [3, 7, 7], "patch_stride": [2, 4, 4], "patch_padding": [1, 3, 3],
    "pool_kvq_kernel": [3, 3, 3], "pool_kv_stride_adaptive": [1, 8, 8],
    "pool_q_stride": [[i, 1, 2, 2] if i in (2, 5, 21) else [i, 1, 1, 1] for i in range(24)],
    "mlp_ratio": 4.0,
}
# the test variant: head dim 96 (the kernel's), five blocks in four stages
# at 8 x 32^2, a query stride at blocks 1, 3 and 4 and key/value strides
# from (1,2,2): key grids smaller than, equal to and larger than the query
# grid; 10 classes
TINY = dict(MVIT_V2_B, frames=8, hw=32, classes=10, depth=5,
            dim_mul=[[1, 2.0], [3, 2.0], [4, 2.0]], head_mul=[[1, 2.0], [3, 2.0], [4, 2.0]],
            pool_kv_stride_adaptive=[1, 2, 2],
            pool_q_stride=[[i, 1, 2, 2] if i in (1, 3, 4) else [i, 1, 1, 1] for i in range(5)])


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block: widths, heads, strides and the (T, H, W) grid it is built
    for (its input at the configured clip size)."""

    dim: int
    dim_out: int
    heads: int
    stride_q: tuple
    stride_kv: tuple
    input_size: tuple

    @property
    def head_dim(self) -> int:
        return self.dim_out // self.heads

    @property
    def table_rows(self) -> tuple:
        """Rows of ``rel_pos_t`` and of ``rel_pos_h``/``rel_pos_w``."""
        size = self.input_size[1]
        return (2 * self.input_size[0] - 1,
                2 * max(size // self.stride_q[1], size // self.stride_kv[1]) - 1)


def patch_grid(spec: dict) -> tuple:
    """The (T, H, W) token grid after the patch embedding."""
    sizes = (spec["frames"], spec["hw"], spec["hw"])
    return tuple((s + 2 * p - k) // st + 1 for s, k, st, p in zip(
        sizes, spec["patch_kernel"], spec["patch_stride"], spec["patch_padding"]))


def block_specs(spec: dict) -> list:
    """Each block's :class:`BlockSpec` (``_prepare_mvit_configs`` and the
    build loop of ``MViT.__init__``)."""
    dim_mul, head_mul = dict((b, m) for b, m in spec["dim_mul"]), \
        dict((b, m) for b, m in spec["head_mul"])
    stride_q = {row[0]: tuple(row[1:]) for row in spec["pool_q_stride"]}
    kv, size = tuple(spec["pool_kv_stride_adaptive"]), patch_grid(spec)
    dim, heads, out = spec["embed_dim"], spec["num_heads"], []
    for i in range(spec["depth"]):
        sq = stride_q.get(i, (1, 1, 1))
        if i in stride_q:
            kv = tuple(max(s // q, 1) for s, q in zip(kv, sq))
        heads = int(heads * head_mul.get(i, 1))
        dim_out = int(dim * dim_mul.get(i, 1))
        out.append(BlockSpec(dim, dim_out, heads, sq, kv, size))
        size = tuple(s // q for s, q in zip(size, sq))
        dim = dim_out
    return out


def stage_ends(spec: dict) -> list:
    """The index of each stage's last block: the block before each width
    change, and the last."""
    starts = sorted(b for b, _ in spec["dim_mul"])
    return [b - 1 for b in starts] + [spec["depth"] - 1]


@cached_tensors
def _distance(q: int, k: int, device: torch.device) -> torch.Tensor:
    """(q, k) long: the table row of each (query, key) coordinate pair along
    one axis, ``i·max(k/q, 1) − j·max(q/k, 1) + (k − 1)·max(q/k, 1)``, in the
    published float arithmetic, truncated."""
    q_ratio, k_ratio = max(k / q, 1.0), max(q / k, 1.0)
    dist = torch.arange(q)[:, None] * q_ratio - torch.arange(k)[None, :] * k_ratio
    dist += (k - 1) * k_ratio
    return dist.long().to(device)


def axis_table(table: torch.Tensor, q: int, k: int) -> torch.Tensor:
    """(q, k, hd): the rows of one axis's table that each (query, key)
    coordinate pair reads, the table resized linearly to ``2·max(q, k) − 1``
    rows first where it has another count (``get_rel_pos``)."""
    rows = 2 * max(q, k) - 1
    if table.shape[0] != rows:
        table = F.interpolate(table.reshape(1, table.shape[0], -1).permute(0, 2, 1),
                              size=rows, mode="linear").reshape(-1, rows).permute(1, 0)
    return table[_distance(q, k, table.device)]


def relative_terms(q: torch.Tensor, q_thw: Sequence[int], k_thw: Sequence[int],
                   rel_t: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor) -> tuple:
    """The three per-query terms of the decomposed relative positions from
    the pooled, unscaled q (B, heads, 1 + Nq, hd): ``(B·heads, Nq, k_t)``,
    ``(…, k_h)`` and ``(…, k_w)``, contiguous float32. The score of spatial
    query i and spatial key j = (t, h, w) gains ``t_i[t] + h_i[h] + w_i[w]``."""
    b, heads, _, c = q.shape
    r = q[:, :, 1:].reshape(b, heads, *q_thw, c)
    rt, rh, rw = (axis_table(tab, qs, ks)
                  for tab, qs, ks in zip((rel_t, rel_h, rel_w), q_thw, k_thw))
    terms = (torch.einsum("bythwc,tkc->bythwk", r, rt),
             torch.einsum("bythwc,hkc->bythwk", r, rh),
             torch.einsum("bythwc,wkc->bythwk", r, rw))
    return tuple(t.reshape(b * heads, -1, t.shape[-1]).contiguous() for t in terms)


def pool_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         terms: tuple) -> torch.Tensor:
    """``softmax(q·hd^-0.5·kᵀ + B)·v + q`` (the residual at rows ≥ 1) of
    every (clip, head), scores materialised, in float32: q (B, heads, 1 +
    Nq, hd), k and v (B, heads, 1 + Nk, hd), ``terms`` from
    :func:`relative_terms` → (B, 1 + Nq, heads·hd). The kernel's oracle and
    the path off the card."""
    b, heads, nq1, hd = q.shape
    rt, rh, rw = (t.view(b, heads, nq1 - 1, t.shape[-1]) for t in terms)
    bias = (rt[..., :, None, None] + rh[..., None, :, None] + rw[..., None, None, :])
    bias = F.pad(bias.reshape(b, heads, nq1 - 1, -1), (1, 0, 1, 0))
    attn = (q * hd ** -0.5) @ k.transpose(-2, -1) + bias
    x = attn.softmax(dim=-1) @ v + F.pad(q[:, :, 1:], (0, 0, 1, 0))
    return x.transpose(1, 2).reshape(b, nq1, heads * hd)


def pool_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   terms: tuple) -> torch.Tensor:
    """The kernel on a card, :func:`pool_attention_plain` elsewhere."""
    if q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, *terms)):
            raise RuntimeError("pooling attention on a card is forward only: its kernel has "
                               "no backward")
        return kernels.launch_pool_attn(q, k, v, *terms)
    return pool_attention_plain(q, k, v, terms)


def attention_pool(t: torch.Tensor, pool: nn.Module, thw: Sequence[int],
                   norm: nn.Module | None = None) -> tuple:
    """``attention_pool``: (B, N, 1 + T·H·W, C) → the class token split off,
    the (T, H, W) grid pooled, the class token joined back and ``norm``
    applied; → (tensor, pooled grid)."""
    b, n, _, c = t.shape
    cls, grid = t[:, :, :1], t[:, :, 1:]
    grid = pool(grid.reshape(b * n, *thw, c).permute(0, 4, 1, 2, 3).contiguous())
    thw = tuple(grid.shape[2:])
    grid = grid.reshape(b, n, c, -1).transpose(2, 3)
    out = torch.cat((cls, grid), dim=2)
    return (out if norm is None else norm(out)), thw


def pool_qkv_plain(qkv: torch.Tensor, attn: nn.Module, thw: Sequence[int]) -> tuple:
    """q, k and v from the qkv Linear's output (B, 1 + T·H·W, 3, heads, hd),
    each through :func:`attention_pool` with its conv and LayerNorm of
    ``attn`` (a :class:`MultiScaleAttention`) → (q, k, v, q grid, k grid). The
    kernel's oracle and the path off the card."""
    t = qkv.permute(2, 0, 3, 1, 4)
    q, q_thw = attention_pool(t[0], attn.pool_q, thw, attn.norm_q)
    k, k_thw = attention_pool(t[1], attn.pool_k, thw, attn.norm_k)
    v, _ = attention_pool(t[2], attn.pool_v, thw, attn.norm_v)
    return q, k, v, q_thw, k_thw


def pool_qkv(qkv: torch.Tensor, attn: nn.Module, thw: Sequence[int]) -> tuple:
    """The kernel on a card (q, k and v in one launch, read from qkv as it
    lies), :func:`pool_qkv_plain` elsewhere."""
    if qkv.is_cuda:
        weights = [m.weight for m in (attn.pool_q, attn.pool_k, attn.pool_v)]
        norms = [(m.weight, m.bias) for m in (attn.norm_q, attn.norm_k, attn.norm_v)]
        params = weights + [p for pair in norms for p in pair]
        if torch.is_grad_enabled() and any(t.requires_grad for t in (qkv, *params)):
            raise RuntimeError("q, k and v pooling on a card is forward only: its kernel has no "
                               "backward")
        return kernels.launch_pool_qkv(qkv, thw, attn.pool_q.stride, attn.pool_k.stride,
                                       weights, norms, attn.norm_q.eps)
    return pool_qkv_plain(qkv, attn, thw)


class MultiScaleAttention(nn.Module):
    def __init__(self, spec: BlockSpec, kernel: Sequence[int]):
        super().__init__()
        self.heads, hd = spec.heads, spec.head_dim
        pad = tuple(x // 2 for x in kernel)
        self.qkv = Linear(spec.dim, 3 * spec.dim_out)
        self.proj = Linear(spec.dim_out, spec.dim_out)
        for name, stride in (("q", spec.stride_q), ("k", spec.stride_kv), ("v", spec.stride_kv)):
            setattr(self, f"pool_{name}", Conv3d(hd, hd, tuple(kernel), stride=stride,
                                                 padding=pad, groups=hd, bias=False))
            setattr(self, f"norm_{name}", LayerNorm(hd, eps=LN_EPS))
        rows_t, rows_sp = spec.table_rows
        self.rel_pos_h = nn.Parameter(torch.zeros(rows_sp, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(rows_sp, hd))
        self.rel_pos_t = nn.Parameter(torch.zeros(rows_t, hd))

    def forward(self, x: torch.Tensor, thw: Sequence[int]) -> tuple:
        b, n, _ = x.shape
        q, k, v, q_thw, k_thw = pool_qkv(self.qkv(x).view(b, n, 3, self.heads, -1), self, thw)
        terms = relative_terms(q, q_thw, k_thw, self.rel_pos_t, self.rel_pos_h, self.rel_pos_w)
        return self.proj(pool_attention(q, k, v, terms)), q_thw


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class MultiScaleBlock(nn.Module):
    def __init__(self, spec: BlockSpec, kernel: Sequence[int], mlp_ratio: float):
        super().__init__()
        self.norm1 = LayerNorm(spec.dim, eps=LN_EPS)
        self.attn = MultiScaleAttention(spec, kernel)
        self.norm2 = LayerNorm(spec.dim_out, eps=LN_EPS)
        self.mlp = Mlp(spec.dim_out, int(spec.dim_out * mlp_ratio))
        self.proj = Linear(spec.dim, spec.dim_out) if spec.dim != spec.dim_out else None
        # the skip's max-pool where the block strides its queries
        self.skip = None
        if any(s > 1 for s in spec.stride_q):
            self.skip = (tuple(s + 1 if s > 1 else s for s in spec.stride_q), spec.stride_q)

    def forward(self, x: torch.Tensor, thw: Sequence[int]) -> tuple:
        xn = self.norm1(x)
        a, thw_out = self.attn(xn, thw)
        if self.proj is not None:
            x = self.proj(xn)
        if self.skip is not None:
            kernel, stride = self.skip
            x = attention_pool(x[:, None], functools.partial(
                max_pool3d, kernel=kernel, stride=stride,
                padding=tuple(k // 2 for k in kernel)), thw)[0][:, 0]
        x = x + a
        return x + self.mlp(self.norm2(x)), thw_out


class MViT(nn.Module):
    """``spec`` holds the published settings (:data:`MVIT_V2_B`'s keys);
    ``taps`` are ``stage{i}`` (1-based); ``truncate`` builds and runs no
    block past the deepest tap's stage and no head; ``remat`` recomputes
    each block in the backward pass (off the card: the kernel has no
    backward)."""

    def __init__(self, spec: dict, num_classes: int | None = None, remat: bool = False,
                 taps: Sequence[str] = (), truncate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.headless = truncate and bool(taps)
        self.specs = block_specs(spec)
        ends = stage_ends(spec)
        n_stages = deepest([int(k[len("stage"):]) for k in taps], truncate, len(ends))
        self.stage_ends = ends[:n_stages]
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv3d(3, spec["embed_dim"], tuple(spec["patch_kernel"]),
                                       stride=tuple(spec["patch_stride"]),
                                       padding=tuple(spec["patch_padding"]))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, spec["embed_dim"]))
        self.blocks = nn.ModuleList(
            MultiScaleBlock(s, spec["pool_kvq_kernel"], spec["mlp_ratio"])
            for s in self.specs[:self.stage_ends[-1] + 1])
        if not self.headless:
            width = self.specs[-1].dim_out
            self.norm = LayerNorm(width, eps=LN_EPS)
            self.head = nn.Module()
            self.head.projection = Linear(width, num_classes or spec["classes"])
        set_compute_dtype(self, dtype)

    def forward(self, clip_bcthw: torch.Tensor, *, normalize: bool = True,
                relu_grad_scale: float = 1.0):
        """→ (logits or None, {"stage1": …, …}); ``normalize`` applies
        ImageNet normalization to a [0,1] clip (off for a normalized one)."""
        x = self.patch_embed.proj(to_compute(clip_bcthw, normalize, self.dtype))
        thw = tuple(x.shape[2:])
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat((self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1), x), dim=1)
        taps, start = {}, 0
        for s, end in enumerate(self.stage_ends):
            for block in self.blocks[start:end + 1]:
                x, thw = remat_call(self.remat, block, x, thw)
            taps[f"stage{s + 1}"] = x[:, 1:].transpose(1, 2).unflatten(2, thw)
            start = end + 1
        if self.headless:
            return None, taps
        return self.head.projection(self.norm(x)[:, 0]).float(), taps


def mvit_v2_b(num_classes: int | None = None, **kw) -> MViT:
    return MViT(MVIT_V2_B, num_classes, **kw)


def mvit_tiny(num_classes: int | None = None, **kw) -> MViT:
    """:data:`TINY`: head dim 96 as MViTv2-B's (the kernel's), five blocks,
    10 classes."""
    return MViT(TINY, num_classes, **kw)
