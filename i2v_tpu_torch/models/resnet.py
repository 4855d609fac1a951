"""ResNet (torchvision-v1 topology) with explicit stage taps.

PyTorch counterpart of :mod:`i2v_tpu.models.resnet`. Tap d ∈ {1..4} is the
output of stage d (the reference hooks ``layer{d}[-1]``,
image_attacks.py:260-262). BatchNorm is folded into the convs, so blocks are
conv+bias. Submodule names follow the JAX parameter tree (``stem``,
``layer{s}_{b}.conv1``, ...), which is what :func:`.convert.from_jax_params`
relies on.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops import pixel
from .common import (Linear, add_offset, collect_tap, conv, conv_act, deepest, max_pool,
                     set_compute_dtype)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = conv(in_ch, features, 1)
        # torchvision v1.5+ puts the stride on the 3x3 conv
        self.conv2 = conv(features, features, 3, stride, 1)
        self.conv3 = conv(features, features * 4, 1)
        self.downsample = conv(in_ch, features * 4, 1, stride) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else conv_act(self.downsample, x, relu=False)
        y = conv_act(self.conv1, x)
        y = conv_act(self.conv2, y)
        return conv_act(self.conv3, y, residual)


class ResNet(nn.Module):
    """ResNet-50/101 family. ``taps`` are stage depths (1..4) to expose;
    ``truncate`` builds and runs no stage past the deepest tap; ``dtype`` is
    the compute dtype (:mod:`.common`)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 23, 3), width: int = 64,
                 num_classes: int = 1000, taps: Sequence[int] = (), truncate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.taps = tuple(taps)
        self.truncate = truncate
        self.stem = conv(3, width, 7, 2, 3)
        self.n_stages = min(4, deepest(self.taps, truncate, 4))
        in_ch = width
        for stage in range(self.n_stages):
            feats = width * (2 ** stage)
            for block in range(stage_sizes[stage]):
                first = block == 0
                self.add_module(f"layer{stage + 1}_{block}", Bottleneck(
                    in_ch, feats, stride=2 if (first and stage > 0) else 1, downsample=first))
                in_ch = feats * 4
        self.stage_sizes = tuple(stage_sizes)
        self.headless = truncate and bool(self.taps)
        self.fc = None if self.headless else Linear(in_ch, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x01, tap_offset=None):
        """→ (logits or None, {stage: activation}). ``tap_offset`` ({stage:
        tensor}) is added to the stage output in-flow: the gradient with
        respect to it at 0 is the exact ∂/∂(tap) that Grad-CAM needs."""
        taps = {}
        x = pixel.normalize(x01, channel_axis=1).to(self.dtype)
        x = conv_act(self.stem, x)
        x = max_pool(x, 3, 2, 1)
        for stage in range(self.n_stages):
            for block in range(self.stage_sizes[stage]):
                x = getattr(self, f"layer{stage + 1}_{block}")(x)
            x = add_offset(x, tap_offset, stage + 1)
            collect_tap(taps, self.taps, stage + 1, x)
        if self.headless:
            return None, taps
        return self.fc(torch.mean(x, dim=(2, 3))).float(), taps


def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def resnet_tiny(**kw) -> ResNet:
    """Toy variant (one block per stage, width 8) for checkpoint-free tests."""
    return ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10, **kw)
