"""The four ENS-I2V surrogates, truncated at their taps, in plain PyTorch.

torchvision's topologies (ResNet-101, VGG-16, SqueezeNet-1.1, AlexNet) with
BatchNorm folded into biased convs, as the port holds them. Each module runs
the ImageNet normalization on [0,1] frames, then its layers up to the tap,
and returns the tap activation (the reference's forward hook,
image_attacks.py:260-271):

  resnet      depth 2 → output of stage 2
  vgg         depth 3 → features[20], the ReLU after conv 19
  squeezenet  depth 2 → the expand3x3 ReLU of Fire 6
  alexnet     depth 3 → features[7], the ReLU after conv 6

Submodule names are the port's (``stem``, ``layer2_3.conv1``, ``conv19``,
``fire6.expand3x3``), so one state dict fills both. ``tiny`` gives the
port's width-reduced test variants."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

# (name, depth) of ENS-I2V (image_attacks.py:366-496)
ENS = (("resnet", 2), ("vgg", 3), ("squeezenet", 2), ("alexnet", 3))


def normalize(x: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[channel_axis] = 3
    mean = torch.tensor(MEAN, dtype=x.dtype, device=x.device).reshape(shape)
    std = torch.tensor(STD, dtype=x.dtype, device=x.device).reshape(shape)
    return (x - mean) / std


def _conv(i: int, o: int, k: int, s: int = 1, p: int = 0) -> nn.Conv2d:
    return nn.Conv2d(i, o, k, s, p, bias=True)


class Bottleneck(nn.Module):
    def __init__(self, i: int, f: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = _conv(i, f, 1)
        self.conv2 = _conv(f, f, 3, stride, 1)
        self.conv3 = _conv(f, 4 * f, 1)
        self.downsample = _conv(i, 4 * f, 1, stride) if downsample else None

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        return F.relu(self.conv3(y) + r)


class ResNetTrunk(nn.Module):
    def __init__(self, depth: int, tiny: bool = False):
        super().__init__()
        sizes, width = ((1, 1, 1, 1), 8) if tiny else ((3, 4, 23, 3), 64)
        self.stem = _conv(3, width, 7, 2, 3)
        self.blocks = []
        i = width
        for s in range(depth):
            f = width * 2 ** s
            for b in range(sizes[s]):
                name = f"layer{s + 1}_{b}"
                self.add_module(name, Bottleneck(i, f, 2 if (b == 0 and s > 0) else 1, b == 0))
                self.blocks.append(name)
                i = 4 * f

    def forward(self, x01):
        x = F.relu(self.stem(normalize(x01)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x


_VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M")


class VGG16Trunk(nn.Module):
    """Up to the ReLU at torchvision feature index ``tap``."""

    def __init__(self, tap: int, tiny: bool = False):
        super().__init__()
        mult = 0.125 if tiny else 1.0
        self.plan, idx, i = [], 0, 3
        for item in _VGG16:
            if idx >= tap:
                break
            if item == "M":
                self.plan.append(None)
                idx += 1
            else:
                o = max(1, int(item * mult))
                self.add_module(f"conv{idx}", _conv(i, o, 3, 1, 1))
                self.plan.append(f"conv{idx}")
                i, idx = o, idx + 2

    def forward(self, x01):
        x = normalize(x01)
        for name in self.plan:
            x = F.max_pool2d(x, 2, 2) if name is None else F.relu(getattr(self, name)(x))
        return x


class AlexNetTrunk(nn.Module):
    _PLAN = ((0, 64, 11, 4, 2, True), (3, 192, 5, 1, 2, True), (6, 384, 3, 1, 1, False),
             (8, 256, 3, 1, 1, False), (10, 256, 3, 1, 1, True))

    def __init__(self, tap: int, tiny: bool = False):
        super().__init__()
        mult = 0.125 if tiny else 1.0
        self.plan, i = [], 3
        for idx, ch, k, s, p, pool in self._PLAN:
            if idx >= tap:
                break
            o = max(1, int(ch * mult))
            self.add_module(f"conv{idx}", _conv(i, o, k, s, p))
            # the tap is the ReLU itself: no pool after the last conv
            self.plan.append((f"conv{idx}", pool and idx + 1 < tap))
            i = o

    def forward(self, x01):
        x = normalize(x01)
        for name, pool in self.plan:
            x = F.relu(getattr(self, name)(x))
            if pool:
                x = F.max_pool2d(x, 3, 2)
        return x


class Fire(nn.Module):
    def __init__(self, i: int, sq: int, ex: int):
        super().__init__()
        self.squeeze = _conv(i, sq, 1)
        self.expand1x1 = _conv(sq, ex, 1)
        self.expand3x3 = _conv(sq, ex, 3, 1, 1)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        e3 = F.relu(self.expand3x3(s))
        return torch.cat([F.relu(self.expand1x1(s)), e3], dim=1), e3


class SqueezeNetTrunk(nn.Module):
    """Up to the expand3x3 ReLU of Fire ``tap`` (a scalar-depth tap)."""

    _PLAN = ((3, 16, 64, False), (4, 16, 64, False), (6, 32, 128, True), (7, 32, 128, False),
             (9, 48, 192, True), (10, 48, 192, False), (11, 64, 256, False),
             (12, 64, 256, False))

    def __init__(self, tap: int, tiny: bool = False):
        super().__init__()
        mult = 0.25 if tiny else 1.0
        i = max(1, int(64 * mult))
        self.conv0 = _conv(3, i, 3, 2)
        self.plan = []
        for idx, sq, ex, pool in self._PLAN:
            if idx > tap:
                break
            ex = max(1, int(ex * mult))
            self.add_module(f"fire{idx}", Fire(i, max(1, int(sq * mult)), ex))
            self.plan.append((f"fire{idx}", pool))
            i = 2 * ex

    def forward(self, x01):
        x = F.relu(self.conv0(normalize(x01)))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        e3 = None
        for name, pool in self.plan:
            if pool:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            x, e3 = getattr(self, name)(x)
        return e3


# depth → torchvision feature index (image_attacks.py:260-271)
_TAP = {"vgg": {1: 1, 2: 11, 3: 20, 4: 29}, "alexnet": {1: 1, 2: 4, 3: 7, 4: 11},
        "squeezenet": {1: 3, 2: 6, 3: 9, 4: 12}}


def build(name: str, depth: int, tiny: bool = False) -> nn.Module:
    """The surrogate ``name`` truncated at ``depth``, float32, eval, frozen."""
    if name == "resnet":
        m = ResNetTrunk(depth, tiny)
    elif name == "vgg":
        m = VGG16Trunk(_TAP["vgg"][depth], tiny)
    elif name == "alexnet":
        m = AlexNetTrunk(_TAP["alexnet"][depth], tiny)
    elif name == "squeezenet":
        m = SqueezeNetTrunk(_TAP["squeezenet"][depth], tiny)
    else:
        raise ValueError(f"no reference surrogate {name!r}")
    return m.eval().requires_grad_(False)
