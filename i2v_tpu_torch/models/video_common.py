"""Shared blocks for the 3-D video backbones (I3D, SlowFast, TPN).

PyTorch counterpart of :mod:`i2v_tpu.models.video_common`:
  - clips enter as ``(B, C, T, H, W)`` in [0,1], which is PyTorch's NCDHW
    already, and stay NCDHW inside; taps are NCDHW too (the JAX package's
    are channel-last ``(B, T, H, W, C)``).
  - BatchNorm is folded into the conv weights by the checkpoint converter,
    so blocks are conv + bias; every conv runs through
    :func:`~.common.conv_act`, which on a card adds the bias, the residual
    and the ReLU in one in-place pass after cuDNN's conv.
  - ``relu_grad_scale`` is passed down through ``forward``: SGM's γ^0.5
    backward scaling of every non-stem ReLU (replacing the reference's
    backward hooks, base_attacks.py:495-511) without a second copy of the
    weights.
  - ``remat`` (:func:`remat_call`) recomputes a block in the backward pass
    instead of keeping its activations, as the JAX package's ``nn.remat``.
  - every model takes a compute ``dtype`` (:mod:`.common`): the clip is
    normalized in float32 and then cast (:func:`to_compute`), the convs and
    the head compute in ``dtype``, and the logits come back as float32.
  - the transformers' index tensors made from shapes (Swin's relative index
    and shift masks, MViT's distances) are cached outside the state dict
    (:func:`cached_tensors`).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from ..ops.pixel import normalize as _normalize
from .common import Conv3d, conv_act


def cached_tensors(fn):
    """Cache ``fn``'s tensors by its arguments, made as ordinary tensors
    (not inference tensors) whatever mode the first caller is in."""
    @functools.lru_cache(maxsize=None)
    def cached(*args):
        with torch.inference_mode(False), torch.no_grad():
            return fn(*args)

    return cached


def conv3d(in_ch: int, out_ch: int, kernel: Sequence[int], stride: Sequence[int] = (1, 1, 1),
           padding: Sequence[int] | None = None, *, groups: int = 1) -> nn.Conv3d:
    """3-D conv with torch-style symmetric integer padding ((k-1)//2 by
    default) and bias; ``groups`` is Flax's ``feature_group_count``."""
    if padding is None:
        padding = tuple((k - 1) // 2 for k in kernel)
    return Conv3d(in_ch, out_ch, tuple(kernel), stride=tuple(stride),
                  padding=tuple(padding), groups=groups, bias=True)


def max_pool3d(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
               padding: Sequence[int] = (0, 0, 0)) -> torch.Tensor:
    """Max pool with −inf padding (floor mode), as Flax's ``nn.max_pool``."""
    return F.max_pool3d(x, tuple(kernel), tuple(stride), tuple(padding))


def max_pool_hw2(x: torch.Tensor) -> torch.Tensor:
    """Non-overlapping (1,2,2) max pool (floor mode: a trailing odd row or
    column is dropped)."""
    return F.max_pool3d(x, (1, 2, 2), (1, 2, 2))


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat``, and while autograd records, its
    activations are recomputed in the backward pass instead of kept. The
    non-reentrant checkpoint lets frozen weights and SGM's scaled ReLU run
    inside; the recompute runs the same forward, so values and gradients are
    those without it, RNG state untouched."""
    if remat and torch.is_grad_enabled():
        # nothing random runs in these frozen models, so the RNG state needs
        # no saving (and a CUDA graph capture refuses to read it)
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


class Bottleneck3D(nn.Module):
    """Inflated bottleneck, I3D's, SlowFast's and TPN's alike. ``inflate``
    selects the '3x1x1' style: a (3,1,1) temporal kernel on the first 1×1
    conv (mmaction/gluoncv I3D convention; SlowFast's and TPN's temporal
    stages); non-inflated blocks are purely spatial. The stride sits on
    ``conv2`` and on the downsample. Each conv's bias, the residual and the
    ReLU come in its epilogue (:func:`~.common.conv_act`)."""

    def __init__(self, in_ch: int, features: int, spatial_stride: int = 1,
                 temporal_stride: int = 1, downsample: bool = False, inflate: bool = True):
        super().__init__()
        st = (temporal_stride, spatial_stride, spatial_stride)
        self.conv1 = conv3d(in_ch, features, (3, 1, 1) if inflate else (1, 1, 1))
        self.conv2 = conv3d(features, features, (1, 3, 3), st)
        self.conv3 = conv3d(features, features * 4, (1, 1, 1))
        self.downsample = conv3d(in_ch, features * 4, (1, 1, 1), st) if downsample else None

    def forward(self, x: torch.Tensor, relu_grad_scale: float = 1.0) -> torch.Tensor:
        y = conv_act(self.conv1, x, relu_grad_scale=relu_grad_scale)
        y = conv_act(self.conv2, y, relu_grad_scale=relu_grad_scale)
        residual = x if self.downsample is None else conv_act(self.downsample, x, relu=False)
        return conv_act(self.conv3, y, residual, relu_grad_scale=relu_grad_scale)


class NonLocal3D(nn.Module):
    """Non-local block (the 'nl' in i3d_nl5): ``out = x + W_z·A(θ(x), φ(x))·g(x)``,
    θ/φ/g projecting to C/2 with 1×1×1 convs.

    ``sub_sample`` max-pools φ and g (1,2,2) after their convs; ``nl_type``
    is the embedded-gaussian softmax ('gaussian') or the 1/M dot product
    ('dot'). Tokens run over T·H·W in that order. The two attention products
    are plain batched matmuls, as the JAX package leaves them to XLA."""

    def __init__(self, channels: int, sub_sample: bool = True, nl_type: str = "gaussian"):
        super().__init__()
        if nl_type not in ("gaussian", "dot"):
            raise ValueError(f"unknown nl_type {nl_type!r}")
        inter = channels // 2
        self.sub_sample = sub_sample
        self.nl_type = nl_type
        self.theta = conv3d(channels, inter, (1, 1, 1))
        self.phi = conv3d(channels, inter, (1, 1, 1))
        self.g = conv3d(channels, inter, (1, 1, 1))
        self.out = conv3d(inter, channels, (1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, t, h, w = x.shape
        theta, phi, g = (conv_act(c, x, relu=False) for c in (self.theta, self.phi, self.g))
        if self.sub_sample:
            phi, g = max_pool_hw2(phi), max_pool_hw2(g)
        inter = theta.shape[1]
        m = phi.shape[2] * phi.shape[3] * phi.shape[4]
        theta = theta.reshape(b, inter, t * h * w).transpose(1, 2)  # (B, N, C')
        phi = phi.reshape(b, inter, m)                                # (B, C', M)
        g = g.reshape(b, inter, m).transpose(1, 2)                    # (B, M, C')
        attn = torch.matmul(theta.float(), phi.float())
        attn = torch.softmax(attn, dim=-1) if self.nl_type == "gaussian" else attn / m
        y = torch.matmul(attn.to(g.dtype).float(), g.float())        # (B, N, C')
        # dense (B, C', T, H, W): the transpose's view is channels-last, which
        # cuDNN would keep in the conv's output, and the epilogue takes dense planes
        y = y.transpose(1, 2).reshape(b, inter, t, h, w).to(x.dtype).contiguous()
        return conv_act(self.out, y, x, relu=False)  # x + out(y): IEEE addition commutes


def to_compute(clip_bcthw: torch.Tensor, normalize: bool, dtype: torch.dtype) -> torch.Tensor:
    """ImageNet normalization of a [0,1] clip in float32 (where asked), then
    the cast to the compute dtype (``video_common.to_channel_last`` of the
    JAX package, without its transpose)."""
    x = _normalize(clip_bcthw, channel_axis=1) if normalize else clip_bcthw
    return x.to(dtype)
