"""Shared building blocks for the image backbones.

PyTorch counterpart of :mod:`i2v_tpu.models.common`:
  - NCHW layout; models take **[0,1]-domain** inputs and apply ImageNet
    normalization as their first op.
  - Feature taps are explicit return values keyed by depth (the reference
    reads them through forward hooks, image_attacks.py:273-292).
  - ``truncate=True`` builds and runs nothing past the deepest requested
    tap: no parameters, no compute (image_attacks.py:318,334 runs the full
    network and hooks the middle; the taps are identical).
  - BatchNorm is folded into the preceding conv (:func:`.convert.fold_bn`),
    so the convs carry a bias and there is no BN module (DenseNet, which is
    pre-activation, keeps a frozen affine instead).
  - Every image module's forward takes ``tap_offset`` ({tap: tensor}),
    added to the tap activation in-flow (Grad-CAM's exact ∂/∂tap).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    """2-D conv with symmetric integer padding and bias."""
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=True)


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    """torch max pool. With ``ceil_mode`` the last partial window is kept;
    for every window shape used here (kernel ≥ stride) that is the JAX
    package's extra right/bottom −inf padding (tests pin the sizes)."""
    return F.max_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode)


def add_offset(x: torch.Tensor, tap_offset, depth: int) -> torch.Tensor:
    """``x + tap_offset[depth]`` where the caller passed one (Grad-CAM's
    in-flow offset, differentiated at 0), else ``x`` itself."""
    if tap_offset is not None and depth in tap_offset:
        return x + tap_offset[depth]
    return x


def collect_tap(taps: dict, want: Sequence[int], depth: int, value) -> None:
    if depth in want:
        taps[depth] = value


def deepest(want: Sequence[int], truncate: bool, everything: int) -> int:
    """The last depth a module builds and runs: the deepest requested tap
    when truncating, else ``everything``."""
    return max(want) if (truncate and want) else everything
