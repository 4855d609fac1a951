"""DenseNet-161 (torchvision topology) with dense-block taps.

PyTorch counterpart of :mod:`i2v_tpu.models.densenet`, NCHW. DenseNet is
pre-activation (BN → ReLU → conv), so its BatchNorms cannot fold into an
adjacent conv: each stays as a frozen affine, :class:`FrozenBN`, whose
parameters are named ``scale`` and ``bias`` as in the Flax tree (the JAX
converter precomputes them from the running statistics). The convs keep
their bias, as the JAX package's do.

Tap ``i`` ∈ {1..4} is dense block ``i``'s output *before* its transition.
The forward returns every computed block as a tap, as the JAX module does;
``truncate`` builds and runs nothing past the deepest requested tap.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import pixel
from .common import Linear, add_offset, conv, max_pool, set_compute_dtype


class FrozenBN(nn.Module):
    """Inference BN as an affine: y = x·scale + bias over the channel axis.
    ``scale`` and ``bias`` stay float32 and are cast to the input's dtype,
    as the JAX module casts them."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return (x * self.scale.to(x.dtype).view(1, -1, 1, 1)
                + self.bias.to(x.dtype).view(1, -1, 1, 1))


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = FrozenBN(in_ch)
        self.conv1 = conv(in_ch, bn_size * growth, 1)
        self.norm2 = FrozenBN(bn_size * growth)
        self.conv2 = conv(bn_size * growth, growth, 3, 1, 1)

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm = FrozenBN(in_ch)
        self.conv = conv(in_ch, out_ch, 1)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """``taps`` are dense-block indices (1..4); ``truncate`` builds and runs
    no block, transition or head past the deepest tap; ``dtype`` is the
    compute dtype (:mod:`.common`)."""

    def __init__(self, block_config: Sequence[int] = (6, 12, 36, 24), growth: int = 48,
                 init_features: int = 96, num_classes: int = 1000, taps: Sequence[int] = (),
                 truncate: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.taps = tuple(taps)
        self.block_config = tuple(block_config)
        n_all = len(self.block_config)
        last = max(self.taps) if (truncate and self.taps) else n_all
        self.n_blocks = min(last, n_all)
        # the JAX module returns early only at a block it has
        self.headless = truncate and bool(self.taps) and last <= n_all
        self.conv0 = conv(3, init_features, 7, 2, 3)
        self.norm0 = FrozenBN(init_features)
        feats = init_features
        for i in range(self.n_blocks):
            for j in range(self.block_config[i]):
                self.add_module(f"denseblock{i + 1}_layer{j + 1}", DenseLayer(feats, growth))
                feats += growth
            if i + 1 < n_all and not (self.headless and i + 1 >= last):
                self.add_module(f"transition{i + 1}", Transition(feats, feats // 2))
                feats //= 2
        if not self.headless:
            self.norm5 = FrozenBN(feats)
            self.classifier = Linear(feats, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x01, tap_offset=None):
        """→ (logits or None, {block: activation}). ``tap_offset`` ({block:
        tensor}) is added to the tap activation in-flow: the gradient with
        respect to it at 0 is the exact ∂/∂(tap) that Grad-CAM needs."""
        taps = {}
        x = pixel.normalize(x01, channel_axis=1).to(self.dtype)
        x = F.relu(self.norm0(self.conv0(x)))
        x = max_pool(x, 3, 2, 1)
        for i in range(self.n_blocks):
            for j in range(self.block_config[i]):
                x = getattr(self, f"denseblock{i + 1}_layer{j + 1}")(x)
            x = taps[i + 1] = add_offset(x, tap_offset, i + 1)
            if self.headless and i + 1 == self.n_blocks:
                return None, taps
            if hasattr(self, f"transition{i + 1}"):
                x = getattr(self, f"transition{i + 1}")(x)
        x = F.relu(self.norm5(x))
        return self.classifier(torch.mean(x, dim=(2, 3))).float(), taps


def densenet161(**kw) -> DenseNet:
    return DenseNet(**kw)


TINY_BLOCKS = (2, 2)


def densenet_tiny(**kw) -> DenseNet:
    """Toy variant (two dense blocks of two layers, growth 8) for tests."""
    return DenseNet(block_config=TINY_BLOCKS, growth=8, init_features=16, num_classes=10, **kw)
