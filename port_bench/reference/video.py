"""The six Kinetics-400 video classifiers in plain PyTorch, float32.

gluoncv's ``i3d_nl5_resnet{50,101}_v1_kinetics400``,
``slowfast_8x8_resnet{50,101}_kinetics400`` and
``tpn_resnet{50,101}_f32s2_kinetics400`` with BatchNorm folded into biased
convs, as the port holds them. A model takes a normalized-domain clip
(B, 3, T, H, W), the artifact protocol's, and returns its logits. Submodule
names are the port's (``layer2_1_nl.theta``, ``slow_res3_1.conv1``,
``lf2_fusion``, ``fc``), so one state dict fills both; ``tiny`` gives the
port's width-8 test variants."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

NAMES = ("i3d_resnet50", "i3d_resnet101", "slowfast_resnet50", "slowfast_resnet101",
         "tpn_resnet50", "tpn_resnet101")


def _conv(i, o, k, s=(1, 1, 1), p=None, groups=1) -> nn.Conv3d:
    p = tuple((x - 1) // 2 for x in k) if p is None else p
    return nn.Conv3d(i, o, tuple(k), tuple(s), tuple(p), groups=groups, bias=True)


class Bottleneck(nn.Module):
    """conv1 (kt,1,1), conv2 (1,3,3) with the spatial stride, conv3 1×1×1."""

    def __init__(self, i, f, out, stride=1, kt=1, downsample=False):
        super().__init__()
        st = (1, stride, stride)
        self.conv1 = _conv(i, f, (kt, 1, 1))
        self.conv2 = _conv(f, f, (1, 3, 3), st)
        self.conv3 = _conv(f, out, (1, 1, 1))
        self.downsample = _conv(i, out, (1, 1, 1), st) if downsample else None

    def forward(self, x):
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class NonLocal(nn.Module):
    """Embedded-gaussian non-local block, φ and g max-pooled (1,2,2)."""

    def __init__(self, c):
        super().__init__()
        self.theta, self.phi = _conv(c, c // 2, (1, 1, 1)), _conv(c, c // 2, (1, 1, 1))
        self.g, self.out = _conv(c, c // 2, (1, 1, 1)), _conv(c // 2, c, (1, 1, 1))

    def forward(self, x):
        b, _, t, h, w = x.shape
        theta = self.theta(x)
        phi = F.max_pool3d(self.phi(x), (1, 2, 2), (1, 2, 2))
        g = F.max_pool3d(self.g(x), (1, 2, 2), (1, 2, 2))
        c = theta.shape[1]
        theta = theta.reshape(b, c, -1).transpose(1, 2)
        attn = torch.softmax(torch.bmm(theta, phi.reshape(b, c, -1)), dim=-1)
        y = torch.bmm(attn, g.reshape(b, c, -1).transpose(1, 2))
        return x + self.out(y.transpose(1, 2).reshape(b, c, t, h, w))


class I3D(nn.Module):
    def __init__(self, sizes, inflate, nl, width=64, classes=400):
        super().__init__()
        self.conv1 = _conv(3, width, (5, 7, 7), (2, 2, 2))
        self.plan, i = [], width
        for s, n in enumerate(sizes):
            f = width * 2 ** s
            for b in range(n):
                name = f"layer{s + 1}_{b}"
                self.add_module(name, Bottleneck(i, f, 4 * f, 2 if (b == 0 and s > 0) else 1,
                                                 3 if inflate[s][b] else 1, b == 0))
                self.plan.append(name)
                i = 4 * f
                if b in nl[s]:
                    self.add_module(name + "_nl", NonLocal(i))
                    self.plan.append(name + "_nl")
            self.plan.append(None if s == 0 else "")  # stage end; None pools T after stage 1
        self.fc = nn.Linear(i, classes)

    def forward(self, x):
        x = F.max_pool3d(F.relu(self.conv1(x)), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for name in self.plan:
            if name is None:
                x = F.max_pool3d(x, (2, 1, 1), (2, 1, 1))
            elif name:
                x = getattr(self, name)(x)
        return self.fc(x.mean(dim=(2, 3, 4)))


class SlowFast(nn.Module):
    def __init__(self, sizes, width=64, beta_inv=8, fast_stride=2, slow_stride=8,
                 classes=400):
        super().__init__()
        self.fs, self.ss = fast_stride, slow_stride
        alpha, fw = slow_stride // fast_stride, width // beta_inv
        self.fast_conv1 = _conv(3, fw, (5, 7, 7), (1, 2, 2))
        self.slow_conv1 = _conv(3, width, (1, 7, 7), (1, 2, 2))
        self.lateral_p1 = _conv(fw, 2 * fw, (5, 1, 1), (alpha, 1, 1))
        self.sizes = sizes
        fin, sin = fw, width + 2 * fw
        for s, n in enumerate(sizes):
            for path in ("fast", "slow"):
                f = width * 2 ** s // (beta_inv if path == "fast" else 1)
                kt = 3 if (path == "fast" or s in (2, 3)) else 1
                i = fin if path == "fast" else sin
                for b in range(n):
                    self.add_module(f"{path}_res{s + 2}_{b}", Bottleneck(
                        i, f, 4 * f, 2 if (b == 0 and s > 0) else 1, kt, b == 0))
                    i = 4 * f
                if path == "fast":
                    fin = i
                else:
                    sin = i
            if s < min(3, len(sizes) - 1):
                lat = 2 * fw * 2 ** s * 4
                self.add_module(f"lateral_res{s + 2}", _conv(fin, lat, (5, 1, 1), (alpha, 1, 1)))
                sin += lat
        self.fc = nn.Linear(sin + fin, classes)

    def forward(self, x):
        pool = (1, 3, 3), (1, 2, 2), (0, 1, 1)
        fast = F.max_pool3d(F.relu(self.fast_conv1(x[:, :, ::self.fs])), *pool)
        slow = F.max_pool3d(F.relu(self.slow_conv1(x[:, :, ::self.ss])), *pool)
        slow = torch.cat([slow, F.relu(self.lateral_p1(fast))], dim=1)
        for s, n in enumerate(self.sizes):
            for b in range(n):
                fast = getattr(self, f"fast_res{s + 2}_{b}")(fast)
            for b in range(n):
                slow = getattr(self, f"slow_res{s + 2}_{b}")(slow)
            if s < min(3, len(self.sizes) - 1):
                slow = torch.cat([slow, F.relu(getattr(self, f"lateral_res{s + 2}")(fast))],
                                 dim=1)
        return self.fc(torch.cat([slow.mean(dim=(2, 3, 4)), fast.mean(dim=(2, 3, 4))], dim=1))


class TPN(nn.Module):
    def __init__(self, sizes, width=64, scales=(32, 32), groups=32, classes=400):
        super().__init__()
        self.scales = scales
        self.conv1 = _conv(3, width, (1, 7, 7), (1, 2, 2))
        self.stages, i = [], width
        for s, n in enumerate(sizes):
            f, names = width * 2 ** s, []
            for b in range(n):
                self.add_module(f"layer{s + 1}_{b}", Bottleneck(
                    i, f, 4 * f, 2 if (b == 0 and s > 0) else 1, 3 if s in (2, 3) else 1,
                    b == 0))
                names.append(f"layer{s + 1}_{b}")
                i = 4 * f
            self.stages.append(names)
        planes, out = 32 * width, 16 * width
        self.sm_0_0 = _conv(16 * width, planes, (1, 3, 3), (1, 2, 2))
        self.tm_0 = _conv(planes, out, (3, 1, 1), groups=groups)
        self.tm_1 = _conv(i, out, (3, 1, 1), groups=groups)
        for prefix in ("lf2", "lf1"):
            for k in range(2):
                self.add_module(f"{prefix}_op{k}", _conv(out, out, (1, 1, 1), groups=groups))
            self.add_module(f"{prefix}_fusion", _conv(2 * out, planes, (1, 1, 1)))
        self.down_0 = _conv(out, out, (3, 1, 1))
        self.pyramid = _conv(2 * planes, planes, (1, 1, 1))
        self.fc = nn.Linear(planes, classes)

    def _fuse(self, prefix, levels):
        ops = [F.relu(getattr(self, f"{prefix}_op{k}")(f)) for k, f in enumerate(levels)]
        return F.relu(getattr(self, f"{prefix}_fusion")(torch.cat(ops, dim=1)))

    def forward(self, x):
        x = F.max_pool3d(F.relu(self.conv1(x)), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        pool = [(k, 1, 1) for k in self.scales]
        fine = F.max_pool3d(self.tm_0(F.relu(self.sm_0_0(feats[2]))), pool[0], pool[0],
                            ceil_mode=True)
        coarse = F.max_pool3d(self.tm_1(feats[3]), pool[1], pool[1], ceil_mode=True)
        fine = fine + coarse
        top = self._fuse("lf2", [fine, coarse])
        coarse = coarse + self.down_0(fine)
        bottom = self._fuse("lf1", [fine, coarse])
        y = F.relu(self.pyramid(torch.cat([top, bottom], dim=1)))
        return self.fc(y.mean(dim=(2, 3, 4)))


_I3D_R50 = ((1, 1, 1), (1, 0, 1, 0), (1, 0, 1, 0, 1, 0), (0, 1, 0))
_I3D_R101 = ((1, 1, 1), (1, 0, 1, 0), tuple((1, 0) * 12)[:23], (0, 1, 0))
_NL5 = ((), (1, 3), (1, 3, 5), ())


def build(name: str, tiny: bool = False) -> nn.Module:
    """The classifier ``name``, float32, eval, frozen."""
    arch, depth = name.split("_resnet")
    sizes = (3, 4, 6, 3) if depth == "50" else (3, 4, 23, 3)
    if arch == "i3d":
        m = (I3D((1, 2, 1, 1), ((1,), (1, 0), (1,), (0,)), ((), (0,), (), ()), 8, 10) if tiny
             else I3D(sizes, _I3D_R50 if depth == "50" else _I3D_R101, _NL5))
    elif arch == "slowfast":
        m = (SlowFast((1, 2, 1, 1), 8, 4, 1, 4, 10) if tiny else SlowFast(sizes))
    elif arch == "tpn":
        m = TPN((1, 2, 1, 1), 8, (2, 2), classes=10) if tiny else TPN(sizes)
    else:
        raise ValueError(f"no reference video model {name!r}")
    return m.eval().requires_grad_(False)
