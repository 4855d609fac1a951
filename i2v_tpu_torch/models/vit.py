"""ViT-B/16 (timm ``vit_base_patch16_224`` topology) with block taps.

PyTorch counterpart of :mod:`i2v_tpu.models.vit`. Tap ``i`` ∈ {0..depth−1}
is block ``i``'s output, a token tensor (b, n, dim); the forward returns
every computed block as a tap, as the JAX module does, and ``truncate`` runs
no block past the deepest requested tap.

Held to the JAX module's arithmetic: LayerNorm ε = 1e-6 (Flax's default,
not torch's 1e-5); attention as the JAX einsum pair with the softmax in
float32 (not ``scaled_dot_product_attention``, whose backends round
differently); exact-erf GELU; the patch embedding flattened row-major over
the grid, as the NHWC ``reshape(b, -1, dim)``; and the position embedding,
sized at ``img_size``, resized for another input with an antialiased
bilinear resize, which is what ``jax.image.resize(..., "bilinear")`` does
when it downsamples (they agree when it upsamples).

In a compute ``dtype`` narrower than float32 (:mod:`.common`) the JAX
module's dtypes are kept: its LayerNorms carry no dtype, so Flax promotes the
input with their float32 parameters and **a LayerNorm's output is float32**
(the next linear casts it back); attention takes its logits and softmax in
float32 from the ``dtype`` queries and keys, casts the weights to the values'
dtype and accumulates the second product in float32 too
(``preferred_element_type=jnp.float32``). A ``dtype`` einsum would round each
product's output to ``dtype``, so the operands are upcast instead: products
of bfloat16 values are exact in float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import pixel
from .common import Conv2d, Linear, add_offset, set_compute_dtype

LN_EPS = 1e-6


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in the promoted dtype of its input and parameters,
    as Flax's ``nn.LayerNorm()`` without a dtype: a bfloat16 input with
    float32 parameters gives a float32 output."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape, self.weight.to(dt),
                            self.bias.to(dt), self.eps)


class MHSA(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads).unbind(2)
        attn = torch.einsum("bnhc,bmhc->bhnm", q.float(), k.float())
        attn = torch.softmax(attn / math.sqrt(d / self.heads), dim=-1)
        y = torch.einsum("bhnm,bmhc->bnhc", attn.to(v.dtype).float(), v.float())
        return self.proj(y.reshape(b, n, d).to(x.dtype))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = MHSA(dim, heads)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.fc1 = Linear(dim, dim * mlp_ratio)
        self.fc2 = Linear(dim * mlp_ratio, dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


def resize_pos_embed(pos: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """(1, 1 + g², dim) → (1, n_tokens, dim): the class token's row kept, the
    g×g grid resized to √(n_tokens − 1) squared (timm's resize_pos_embed)."""
    dim = pos.shape[-1]
    g = int(round((pos.shape[1] - 1) ** 0.5))
    n = int(round((n_tokens - 1) ** 0.5))
    grid = pos[:, 1:].reshape(1, g, g, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(n, n), mode="bilinear", align_corners=False,
                         antialias=True)
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, n * n, dim)], dim=1)


class ViT(nn.Module):
    """``taps`` are block indices (0..depth−1); ``truncate`` builds and runs
    no block, final norm or head past the deepest tap; ``dtype`` is the
    compute dtype."""

    def __init__(self, patch: int = 16, img_size: int = 224, dim: int = 768, depth: int = 12,
                 heads: int = 12, num_classes: int = 1000, taps: Sequence[int] = (),
                 truncate: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.taps = tuple(taps)
        self.patch = patch
        last = max(self.taps) if (truncate and self.taps) else depth - 1
        self.n_blocks = min(last + 1, depth)
        self.headless = truncate and bool(self.taps) and last < depth
        self.patch_embed = Conv2d(3, dim, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (img_size // patch) ** 2 + 1, dim))
        for i in range(self.n_blocks):
            self.add_module(f"block{i}", Block(dim, heads))
        if not self.headless:
            self.norm = LayerNorm(dim, eps=LN_EPS)
            self.head = Linear(dim, num_classes)
        set_compute_dtype(self, dtype)

    def _embed(self, x):
        h, w = x.shape[-2:]
        # Flax's 'SAME' padding of the patch conv (none when the patch divides)
        ph, pw = -h % self.patch, -w % self.patch
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return self.patch_embed(x).flatten(2).transpose(1, 2)

    def forward(self, x01, tap_offset=None):
        """→ (logits or None, {block: tokens}). ``tap_offset`` ({block:
        tensor}) is added to the tap activation in-flow."""
        taps = {}
        x = self._embed(pixel.normalize(x01, channel_axis=1).to(self.dtype))
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1).to(x.dtype), x], dim=1)
        pos = self.pos_embed
        if pos.shape[1] != x.shape[1]:
            pos = resize_pos_embed(pos, x.shape[1])
        x = x + pos.to(x.dtype)
        for i in range(self.n_blocks):
            x = taps[i] = add_offset(getattr(self, f"block{i}")(x), tap_offset, i)
        if self.headless:
            return None, taps
        return self.head(self.norm(x)[:, 0]).float(), taps


def vit_base_patch16_224(**kw) -> ViT:
    return ViT(**kw)


TINY_DEPTH = 2


def vit_tiny(**kw) -> ViT:
    """Toy variant (patch 8 at 32², width 32, two blocks) for tests."""
    return ViT(patch=8, img_size=32, dim=32, depth=TINY_DEPTH, heads=4, num_classes=10, **kw)
