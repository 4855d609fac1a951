"""Video Swin Transformer (Liu et al., "Video Swin Transformer", CVPR 2022;
arXiv:2106.13230), Swin-B on Kinetics-400: patch (2,4,4), embedding 128,
depths (2,2,18,2), heads (4,8,16,32), window (8,7,7), MLP ratio 4, qkv
bias, LayerNorm ε 1e-5; the head averages over (T,H,W) and maps 1024 → 400
classes. The published code (``SwinTransformer3D`` of
``github.com/SwinTransformer/Video-Swin-Transformer``, config
``swin_base_patch244_window877_kinetics400_1k.py``) is followed equation for
equation, quirks included:

  - block: ``x = x + attn(norm1(x)); x = x + mlp(norm2(x))``, GELU exact (erf);
  - attention: pad to whole windows after ``norm1`` (zeros: padded tokens
    take part as keys, unmasked), roll by −shift, partition, ``qkv``,
    ``q·hd^-0.5``, ``qkᵀ``, plus ``table[index[:N, :N]]`` (the index of the
    configured window, sliced to the used window's token count), plus −100
    between tokens of different shift regions on shifted blocks, softmax,
    ``·v``, ``proj``, reverse, roll back, unpad;
  - every second block of a stage is shifted by half the window, (4,3,3);
    the window and shift of a block follow ``get_window_size``: along an
    axis whose grid is no larger than the window, the window is the grid and
    the shift 0 (at 32×224², stage 4's 7×7 grid is its whole window: a
    shift of (4,0,0), full spatial attention);
  - patch merging concatenates ``x[:, :, 0::2, 0::2]``, ``[1::2, 0::2]``,
    ``[0::2, 1::2]``, ``[1::2, 1::2]``, then LayerNorm(4C) and a bias-free
    ``Linear(4C → 2C)``; the patch embedding pads T, H, W to the patch and
    applies a LayerNorm (``patch_norm``).

Inside, tokens are channel-last ``(B, T, H, W, C)``; taps ``stage{i}`` are
the outputs of stage ``i``'s blocks (before the merging that opens the next
stage), NCDHW views like the other video models' taps. ``truncate`` with
taps builds and runs no stage past the deepest tap and no head.

The window attention's core, ``softmax(q·scale·kᵀ + bias + mask)·v`` of
every (window, head), is one hand-written kernel on a card
(:func:`~i2v_tpu_torch.ops.kernels.launch_window_attn`, forward only: under
autograd on a card it raises) and :func:`window_attention_plain` elsewhere,
which is the kernel's oracle. The module holds no buffer: the plain path's
relative index and shift masks are cached per (device, shape) outside the
state dict, and the kernel computes both from each token's coordinates.

Compute ``dtype`` (:mod:`.common`): convs and linears compute in it; the
LayerNorms, as ViT's, give the promoted dtype of their input and float32
parameters, so the residual stream stays float32; attention takes q, k, v in
``dtype`` and its products and softmax in float32 (ViT's rule) and returns
``dtype``; the logits come back as float32. ``relu_grad_scale`` (SGM) has no
ReLU to scale here. Forward passes on the card carry ``record_function``
labels ``swin3d.stage{i}``."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import kernels
from .common import Conv3d, Linear, deepest, set_compute_dtype
from .video_common import cached_tensors, remat_call, to_compute
from .vit import LayerNorm

LN_EPS = 1e-5
MASK_VALUE = -100.0


def table_rows(window: Sequence[int]) -> int:
    """Rows of the relative-position bias table of a window: 2535 for (8,7,7)."""
    return math.prod(2 * w - 1 for w in window)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One block's windows over a ``grid`` of tokens: the ``window`` and
    ``shift`` it uses (``get_window_size``) and the ``full_window`` it was
    configured with, whose relative index the bias is read through."""

    grid: tuple
    window: tuple
    shift: tuple
    full_window: tuple

    @property
    def padded(self) -> tuple:
        return tuple(-(-g // w) * w for g, w in zip(self.grid, self.window))

    @property
    def counts(self) -> tuple:
        """Windows along T, H and W."""
        return tuple(p // w for p, w in zip(self.padded, self.window))

    @property
    def tokens(self) -> int:
        return math.prod(self.window)

    @property
    def shifted(self) -> bool:
        return any(s > 0 for s in self.shift)


def window_geometry(grid: Sequence[int], window: Sequence[int],
                    shift: Sequence[int]) -> Geometry:
    """``get_window_size``: along an axis whose grid is no larger than the
    window, the window shrinks to the grid and the shift to 0."""
    win, sh = list(window), list(shift)
    for i, g in enumerate(grid):
        if g <= window[i]:
            win[i], sh[i] = g, 0
    return Geometry(tuple(grid), tuple(win), tuple(sh), tuple(window))


def partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) → (B·nW, N, C), windows in (D, H, W) order."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.view(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


def reverse(windows: torch.Tensor, window: Sequence[int], b: int,
            padded: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`partition`: → (B, D, H, W, C)."""
    wd, wh, ww = window
    d, h, w = padded
    x = windows.view(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def _axis_regions(size: int, window: int, shift: int) -> torch.Tensor:
    """The shift region (0, 1, 2) of each position of one padded axis, in
    the rolled frame: ``compute_mask``'s three slices. An unshifted axis is
    one region."""
    pos = torch.arange(size)
    if shift == 0:
        return torch.zeros(size, dtype=torch.long)
    return (pos >= size - window).long() + (pos >= size - shift).long()


@cached_tensors
def _relative_index(full_window: tuple, n: int, device: torch.device) -> torch.Tensor:
    """``relative_position_index[:n, :n]`` of ``full_window``, (n, n) long."""
    fd, fh, fw = full_window
    t = torch.arange(math.prod(full_window))[:n]
    code = (t // (fh * fw)) * (2 * fh - 1) * (2 * fw - 1) + (t // fw % fh) * (2 * fw - 1) \
        + t % fw
    corner = (fd - 1) * (2 * fh - 1) * (2 * fw - 1) + (fh - 1) * (2 * fw - 1) + (fw - 1)
    return (code[:, None] - code[None, :] + corner).to(device)


@cached_tensors
def _shift_mask(geo: Geometry, device: torch.device) -> torch.Tensor:
    """(nW, N, N) float32: −100 between tokens of different shift regions of
    each window of a clip, else 0."""
    regions = [_axis_regions(p, w, s) for p, w, s in zip(geo.padded, geo.window, geo.shift)]
    rid = regions[0][:, None, None] * 9 + regions[1][None, :, None] * 3 \
        + regions[2][None, None, :]
    rid = partition(rid[None, ..., None], geo.window)[..., 0]
    mask = torch.where(rid[:, :, None] != rid[:, None, :], MASK_VALUE, 0.0)
    return mask.to(torch.float32).to(device)


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                           geo: Geometry) -> torch.Tensor:
    """``softmax(q·hd^-0.5·kᵀ + table[index[:N, :N]] (+ mask))·v`` of every
    (window, head), in float32: qkv (B·nW, N, 3, heads, hd) → (B·nW, N,
    heads·hd) in qkv's dtype. The kernel's oracle and the path off the card."""
    bw, n, _, heads, hd = qkv.shape
    q, k, v = qkv.float().unbind(2)
    attn = torch.einsum("bnhc,bmhc->bhnm", q * hd ** -0.5, k)
    index = _relative_index(geo.full_window, n, qkv.device)
    attn = attn + table.float()[index].permute(2, 0, 1)
    if geo.shifted:
        mask = _shift_mask(geo, qkv.device)
        attn = (attn.view(-1, mask.shape[0], heads, n, n) + mask[:, None]).view(bw, heads, n, n)
    out = torch.einsum("bhnm,bmhc->bnhc", attn.softmax(dim=-1), v)
    return out.reshape(bw, n, heads * hd).to(qkv.dtype)


def window_attention(qkv: torch.Tensor, table: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """The kernel on a card, :func:`window_attention_plain` elsewhere."""
    if qkv.is_cuda:
        if torch.is_grad_enabled() and (qkv.requires_grad or table.requires_grad):
            raise RuntimeError("window attention on a card is forward only: its kernel has "
                               "no backward")
        return kernels.launch_window_attn(
            qkv, table, window=geo.window, full_window=geo.full_window, shift=geo.shift,
            counts=geo.counts)
    return window_attention_plain(qkv, table, geo)


class WindowAttention3D(nn.Module):
    def __init__(self, dim: int, heads: int, window: Sequence[int]):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(table_rows(window), heads))

    def forward(self, windows: torch.Tensor, geo: Geometry) -> torch.Tensor:
        bw, n, c = windows.shape
        qkv = self.qkv(windows).view(bw, n, 3, self.heads, c // self.heads)
        return self.proj(window_attention(qkv, self.relative_position_bias_table, geo))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock3D(nn.Module):
    def __init__(self, dim: int, heads: int, window: Sequence[int], shift: Sequence[int],
                 mlp_ratio: int = 4):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention3D(dim, heads, window)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, _ = x.shape
        geo = window_geometry((d, h, w), self.window, self.shift)
        y = self.norm1(x)
        pad = [p - g for p, g in zip(geo.padded, geo.grid)]
        if any(pad):
            y = F.pad(y, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        if geo.shifted:
            y = torch.roll(y, shifts=tuple(-s for s in geo.shift), dims=(1, 2, 3))
        y = reverse(self.attn(partition(y, geo.window), geo), geo.window, b, geo.padded)
        if geo.shifted:
            y = torch.roll(y, shifts=geo.shift, dims=(1, 2, 3))
        if any(pad):
            y = y[:, :d, :h, :w]
        return y

    def forward(self, x):
        x = x + self._attention(x)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[2:4]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2],
                       x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    """A stage's blocks, every second one shifted by half the window, and
    the merging that halves H and W for the next stage (``downsample``)."""

    def __init__(self, dim: int, depth: int, heads: int, window: Sequence[int],
                 downsample: bool):
        super().__init__()
        shift = tuple(w // 2 for w in window)
        self.blocks = nn.ModuleList(
            SwinBlock3D(dim, heads, window, (0, 0, 0) if i % 2 == 0 else shift)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed3D(nn.Module):
    def __init__(self, patch: Sequence[int], dim: int):
        super().__init__()
        self.patch = tuple(patch)
        self.proj = Conv3d(3, dim, self.patch, stride=self.patch)
        self.norm = LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        pads = [-s % p for s, p in zip(x.shape[2:], self.patch)]
        if any(pads):
            x = F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0]))
        return self.norm(self.proj(x).permute(0, 2, 3, 4, 1))


class SwinTransformer3D(nn.Module):
    """``taps`` are ``stage{i}`` (1-based); ``truncate`` builds and runs no
    stage past the deepest tap and no head; ``remat`` recomputes each block
    in the backward pass (off the card: the kernel has no backward)."""

    def __init__(self, patch: Sequence[int] = (2, 4, 4), dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2), heads: Sequence[int] = (4, 8, 16, 32),
                 window: Sequence[int] = (8, 7, 7), mlp_ratio: int = 4, num_classes: int = 400,
                 remat: bool = False, taps: Sequence[str] = (), truncate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.headless = truncate and bool(taps)
        n_stages = deepest([int(k[len("stage"):]) for k in taps], truncate, len(depths))
        self.patch_embed = PatchEmbed3D(patch, dim)
        self.layers = nn.ModuleList(
            SwinStage(dim * 2**i, depths[i], heads[i], window,
                      downsample=i + 1 < len(depths) and i + 1 < n_stages)
            for i in range(n_stages))
        if not self.headless:
            self.norm = LayerNorm(dim * 2 ** (len(depths) - 1), eps=LN_EPS)
            self.fc = Linear(dim * 2 ** (len(depths) - 1), num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, clip_bcthw: torch.Tensor, *, normalize: bool = True,
                relu_grad_scale: float = 1.0):
        """→ (logits or None, {"stage1": …, …}); ``normalize`` applies
        ImageNet normalization to a [0,1] clip (off for a normalized one)."""
        x = self.patch_embed(to_compute(clip_bcthw, normalize, self.dtype))
        taps = {}
        for i, stage in enumerate(self.layers):
            with torch.profiler.record_function(f"swin3d.stage{i + 1}"):
                for block in stage.blocks:
                    x = remat_call(self.remat, block, x)
                taps[f"stage{i + 1}"] = x.permute(0, 4, 1, 2, 3)
                if stage.downsample is not None:
                    x = stage.downsample(x)
        if self.headless:
            return None, taps
        return self.fc(self.norm(x).mean(dim=(1, 2, 3))).float(), taps


def swin3d_b(**kw) -> SwinTransformer3D:
    return SwinTransformer3D(**kw)


def swin3d_tiny(**kw) -> SwinTransformer3D:
    """Width-32 variant for tests: head dim 32 as Swin-B's (the kernel's),
    window (4,3,3), two blocks a stage, 10 classes."""
    kw.setdefault("num_classes", 10)
    return SwinTransformer3D(dim=32, depths=(2, 2, 2, 2), heads=(1, 2, 4, 8),
                             window=(4, 3, 3), **kw)
