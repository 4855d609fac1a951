"""VGG-16 / AlexNet / SqueezeNet-1.1 with taps keyed by torchvision feature
index, so the reference's depth→layer tables port verbatim
(image_attacks.py:260-271):

  vgg16      depth→index {1:1, 2:11, 3:20, 4:29}   (ReLU outputs)
  alexnet    depth→index {1:1, 2:4,  3:7,  4:11}   (ReLU outputs)
  squeezenet depth→index {1:3, 2:6,  3:9,  4:12}   (Fire expand3x3 ReLU)

PyTorch counterpart of :mod:`i2v_tpu.models.vgg`, NCHW. Submodules are named
as the JAX parameter tree names them (``conv{i}``, ``fire{i}.squeeze``,
``fc1``...). The classifier heads of VGG and AlexNet are fed by a flatten;
``flatten_fed`` records the (C, H, W) of that flatten for the converter.
Each forward takes ``tap_offset`` ({index: tensor}), added to the tap in-flow
(Grad-CAM); each module takes a compute ``dtype`` (:mod:`.common`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import pixel
from .common import Linear, add_offset, collect_tap, conv, deepest, max_pool, set_compute_dtype

_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")

_ALL = 10 ** 9


def _width(ch: int, mult: float) -> int:
    return max(1, int(ch * mult))


def _add_mlp_head(module: nn.Module, in_features: int, num_classes: int) -> None:
    module.fc1 = Linear(in_features, 4096)
    module.fc2 = Linear(4096, 4096)
    module.fc3 = Linear(4096, num_classes)


def _run_mlp_head(module: nn.Module, x):
    x = torch.flatten(x, 1)
    x = F.relu(module.fc1(x))
    x = F.relu(module.fc2(x))
    return module.fc3(x).float()


class VGG16(nn.Module):
    """``input_hw`` sizes the flatten-fed head (the torchvision head sees
    7×7 at 224²); it is unused when the module is truncated."""

    def __init__(self, num_classes: int = 1000, taps: Sequence[int] = (),
                 truncate: bool = False, width_mult: float = 1.0, input_hw: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.taps = tuple(taps)
        last = deepest(self.taps, truncate, _ALL)
        self.plan = []  # ("pool", idx) | ("conv", idx)
        idx, in_ch = 0, 3
        for item in _VGG16_CFG:
            if idx > last:
                break
            if item == "M":
                self.plan.append(("pool", idx))
                idx += 1
            else:
                ch = _width(item, width_mult)
                self.add_module(f"conv{idx}", conv(in_ch, ch, 3, 1, 1))
                self.plan.append(("conv", idx))
                in_ch = ch
                idx += 2  # conv, relu
        self.headless = truncate and bool(self.taps)
        s = input_hw // 32
        self.flatten_fed = {} if self.headless else {"fc1": (in_ch, s, s)}
        if not self.headless:
            _add_mlp_head(self, in_ch * s * s, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x01, tap_offset=None):
        taps = {}
        x = pixel.normalize(x01, channel_axis=1).to(self.dtype)
        for kind, idx in self.plan:
            if kind == "pool":
                x = max_pool(x, 2, 2)
            else:
                x = add_offset(F.relu(getattr(self, f"conv{idx}")(x)), tap_offset, idx + 1)
                collect_tap(taps, self.taps, idx + 1, x)
        if self.headless:
            return None, taps
        return _run_mlp_head(self, x), taps


class AlexNet(nn.Module):
    # (features-index-of-conv, ch, kernel, stride, pad, pool-after?)
    _PLAN = ((0, 64, 11, 4, 2, True), (3, 192, 5, 1, 2, True),
             (6, 384, 3, 1, 1, False), (8, 256, 3, 1, 1, False),
             (10, 256, 3, 1, 1, True))

    def __init__(self, num_classes: int = 1000, taps: Sequence[int] = (),
                 truncate: bool = False, width_mult: float = 1.0, input_hw: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.taps = tuple(taps)
        last = deepest(self.taps, truncate, _ALL)
        self.plan = []  # (conv idx, pool-after?)
        in_ch, s = 3, input_hw
        for conv_idx, ch, k, st, p, pool_after in self._PLAN:
            if conv_idx > last:
                break
            ch = _width(ch, width_mult)
            self.add_module(f"conv{conv_idx}", conv(in_ch, ch, k, st, p))
            self.plan.append((conv_idx, pool_after))
            in_ch = ch
            s = (s + 2 * p - k) // st + 1
            if pool_after:
                s = (s - 3) // 2 + 1
        self.headless = truncate and bool(self.taps)
        self.flatten_fed = {} if self.headless else {"fc1": (in_ch, s, s)}
        if not self.headless:
            _add_mlp_head(self, in_ch * s * s, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x01, tap_offset=None):
        taps = {}
        x = pixel.normalize(x01, channel_axis=1).to(self.dtype)
        for conv_idx, pool_after in self.plan:
            x = add_offset(F.relu(getattr(self, f"conv{conv_idx}")(x)), tap_offset,
                           conv_idx + 1)
            collect_tap(taps, self.taps, conv_idx + 1, x)
            if pool_after:
                x = max_pool(x, 3, 2)
        if self.headless:
            return None, taps
        return _run_mlp_head(self, x), taps


class Fire(nn.Module):
    def __init__(self, in_ch: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = conv(in_ch, squeeze, 1)
        self.expand1x1 = conv(squeeze, expand, 1)
        self.expand3x3 = conv(squeeze, expand, 3, 1, 1)

    def forward(self, x, offset=None, offset_on_concat: bool = False):
        """Returns (concat output, expand3x3 ReLU) — the second value is the
        reference's scalar-depth SqueezeNet tap (``expand3x3_activation``).
        ``offset`` is added in-flow to whichever tensor is the tap: e3 by
        default, the concat when ``offset_on_concat`` (list-depth taps)."""
        s = F.relu(self.squeeze(x))
        e1 = F.relu(self.expand1x1(s))
        e3 = F.relu(self.expand3x3(s))
        if offset is not None and not offset_on_concat:
            e3 = e3 + offset
        out = torch.cat([e1, e3], dim=1)
        if offset is not None and offset_on_concat:
            out = out + offset
        return out, e3


class SqueezeNet11(nn.Module):
    """``fire_taps=False`` (scalar-depth attacks) taps the expand3x3 ReLU
    (image_attacks.py:268-271); ``fire_taps=True`` (AENS list depths) taps the
    whole Fire output, concat(e1, e3) (TPAMI_attack.py:197-200)."""

    # (feature index, squeeze ch, expand ch, pool-before?)
    _PLAN = ((3, 16, 64, False), (4, 16, 64, False),
             (6, 32, 128, True), (7, 32, 128, False),
             (9, 48, 192, True), (10, 48, 192, False),
             (11, 64, 256, False), (12, 64, 256, False))

    def __init__(self, num_classes: int = 1000, taps: Sequence[int] = (),
                 truncate: bool = False, width_mult: float = 1.0, fire_taps: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.taps = tuple(taps)
        self.fire_taps = fire_taps
        last = deepest(self.taps, truncate, _ALL)
        in_ch = _width(64, width_mult)
        self.conv0 = conv(3, in_ch, 3, 2)
        self.plan = []  # (fire idx, pool-before?)
        for idx, sq, ex, pool_before in self._PLAN:
            if idx > last:
                break
            self.add_module(f"fire{idx}",
                            Fire(in_ch, _width(sq, width_mult), _width(ex, width_mult)))
            self.plan.append((idx, pool_before))
            in_ch = 2 * _width(ex, width_mult)
        self.headless = truncate and bool(self.taps)
        self.classifier = None if self.headless else conv(in_ch, num_classes, 1)
        set_compute_dtype(self, dtype)

    def forward(self, x01, tap_offset=None):
        taps = {}
        x = pixel.normalize(x01, channel_axis=1).to(self.dtype)
        x = F.relu(self.conv0(x))
        x = max_pool(x, 3, 2, ceil_mode=True)
        for idx, pool_before in self.plan:
            if pool_before:
                x = max_pool(x, 3, 2, ceil_mode=True)
            off = tap_offset.get(idx) if tap_offset is not None else None
            x, e3 = getattr(self, f"fire{idx}")(x, off, self.fire_taps)
            collect_tap(taps, self.taps, idx, x if self.fire_taps else e3)
        if self.headless:
            return None, taps
        x = F.relu(self.classifier(x))
        return torch.mean(x, dim=(2, 3)).float(), taps
