"""gluoncv-named torch video models, for checking the checkpoint converter.

``tools/torch_convert_gluoncv.py`` reads gluoncv state_dicts; neither
gluoncv nor its checkpoints are needed to check it. These are plain torch
modules with gluoncv's (mmaction-lineage) parameter names and with the
forward that the JAX package's modules and the port's restate (BatchNorm
in eval mode, where the port folds it into the conv before it):

  - :class:`I3DResNet`: ``first_stage.{0,1}``, ``res_layers.{i}.{j}.
    conv{k}.{conv,bn}`` and ``downsample.{conv,bn}``, non-local blocks under
    ``res_layers.{i}.{j}.nonlocal_block.{theta,phi,g,conv_out.{conv,bn}}``,
    ``fc``;
  - :class:`SlowFast`: ``{slow,fast}_conv1``/``_bn1``,
    ``{slow,fast}_res{2..5}.{j}.conv{k}.{conv,bn}``, the bare lateral convs
    ``lateral_{p1,res2,res3,res4}``, ``fc``;
  - :class:`TPN`: ``conv1.{conv,bn}``, ``layer{1..4}.{j}.conv{k}.{conv,bn}``,
    the TPN repository's neck under ``necks.*``, ``fc``.

Depth and width are arguments: the tests build them narrow, ``chip_smoke``
builds I3D-R50 with its five non-local blocks at full width. Each forward
takes an ImageNet-normalized clip (:func:`normalize`), as gluoncv's models
do, and returns the logits (TPN: the logits and the four stage outputs).
:func:`randomize_bn` gives every BatchNorm non-trivial statistics, so that
the fold is exercised.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

# '3x1x1' inflation per stage and block, and the non-local positions, of
# gluoncv's i3d_nl5_resnet50_v1_kinetics400
I3D_R50_INFLATE = ((1, 1, 1), (1, 0, 1, 0), (1, 0, 1, 0, 1, 0), (0, 1, 0))
I3D_R50_NONLOCAL = ((), (1, 3), (1, 3, 5), ())


def normalize(x01: torch.Tensor) -> torch.Tensor:
    """A [0,1] (B, 3, T, H, W) clip → ImageNet-normalized."""
    mean = torch.tensor([0.485, 0.456, 0.406], device=x01.device).view(1, 3, 1, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], device=x01.device).view(1, 3, 1, 1, 1)
    return (x01 - mean) / std


def randomize_bn(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded non-trivial BatchNorm statistics and affines, drawn on the CPU."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
    return model


def _same_pad(kernel) -> tuple:
    return tuple((k - 1) // 2 for k in kernel)


class ConvBN(nn.Module):
    """mmaction's ConvModule without its activation: ``conv``, ``bn``."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 groups: int = 1):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel, stride, _same_pad(kernel), bias=False,
                              groups=groups)
        self.bn = nn.BatchNorm3d(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


class NonLocal(nn.Module):
    """The embedded-gaussian non-local block: θ/φ/g 1×1×1 convs with bias,
    optional (1,2,2) max-pool sub-sampling of φ and g after their convs,
    ``x + conv_out(A·g)``."""

    def __init__(self, c: int, sub_sample: bool = True):
        super().__init__()
        inter = c // 2
        self.theta = nn.Conv3d(c, inter, 1)
        self.phi = nn.Conv3d(c, inter, 1)
        self.g = nn.Conv3d(c, inter, 1)
        self.max_pool = nn.MaxPool3d((1, 2, 2)) if sub_sample else None
        self.conv_out = ConvBN(inter, c)

    def forward(self, x):
        b, _, t, h, w = x.shape
        theta, phi, g = self.theta(x), self.phi(x), self.g(x)
        if self.max_pool is not None:
            phi, g = self.max_pool(phi), self.max_pool(g)
        theta, phi, g = theta.flatten(2), phi.flatten(2), g.flatten(2)
        attn = torch.softmax(theta.transpose(1, 2) @ phi, dim=-1)
        y = (attn @ g.transpose(1, 2)).transpose(1, 2).reshape(b, -1, t, h, w)
        return x + self.conv_out(y)


class Bottleneck(nn.Module):
    """conv{1,2,3}.{conv,bn} and downsample.{conv,bn}; a (tk,1,1) conv1, the
    spatial stride on conv2 and the downsample; an optional trailing
    ``nonlocal_block``."""

    def __init__(self, cin: int, feats: int, spatial_stride: int = 1, temporal_kernel: int = 1,
                 downsample: bool = False, nonlocal_sub_sample=None):
        super().__init__()
        st = (1, spatial_stride, spatial_stride)
        self.conv1 = ConvBN(cin, feats, (temporal_kernel, 1, 1))
        self.conv2 = ConvBN(feats, feats, (1, 3, 3), st)
        self.conv3 = ConvBN(feats, feats * 4)
        self.downsample = ConvBN(cin, feats * 4, stride=st) if downsample else None
        self.relu = nn.ReLU()
        if nonlocal_sub_sample is not None:
            self.nonlocal_block = NonLocal(feats * 4, nonlocal_sub_sample)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.conv1(x))
        y = self.relu(self.conv2(y))
        y = self.relu(self.conv3(y) + r)
        if hasattr(self, "nonlocal_block"):
            y = self.nonlocal_block(y)
        return y


def _stage(cin: int, feats: int, n_blocks: int, stride: int, temporal_kernels,
           nonlocal_blocks=(), sub_sample: bool = True) -> tuple[nn.Sequential, int]:
    blocks = []
    for j in range(n_blocks):
        blocks.append(Bottleneck(cin, feats, stride if j == 0 else 1, temporal_kernels[j],
                                 downsample=j == 0,
                                 nonlocal_sub_sample=sub_sample if j in nonlocal_blocks
                                 else None))
        cin = feats * 4
    return nn.Sequential(*blocks), cin


class I3DResNet(nn.Module):
    """gluoncv's I3D ResNet (i3d_nl5_resnet50_v1 at the defaults)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 inflate: Sequence[Sequence[int]] = I3D_R50_INFLATE,
                 nonlocal_pos: Sequence[Sequence[int]] = I3D_R50_NONLOCAL,
                 sub_sample: bool = True, width: int = 64, num_classes: int = 400):
        super().__init__()
        self.first_stage = nn.Sequential(
            nn.Conv3d(3, width, (5, 7, 7), (2, 2, 2), (2, 3, 3), bias=False),
            nn.BatchNorm3d(width), nn.ReLU(),
            nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)))
        layers, cin = [], width
        for stage, n in enumerate(stage_sizes):
            layer, cin = _stage(cin, width * 2**stage, n, 2 if stage > 0 else 1,
                                [3 if inflate[stage][j] else 1 for j in range(n)],
                                nonlocal_pos[stage], sub_sample)
            layers.append(layer)
        self.res_layers = nn.ModuleList(layers)
        self.pool2 = nn.MaxPool3d((2, 1, 1), (2, 1, 1))
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = self.first_stage(x)
        for i, layer in enumerate(self.res_layers):
            x = layer(x)
            if i == 0:
                x = self.pool2(x)
        return self.fc(x.mean((2, 3, 4)))


class SlowFast(nn.Module):
    """gluoncv's SlowFast 8x8 (slowfast_8x8_resnet50 at the defaults): the
    model samples its own input, every ``fast_stride``-th frame for the fast
    pathway and every ``slow_stride``-th for the slow one."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 beta_inv: int = 8, fast_stride: int = 2, slow_stride: int = 8,
                 num_classes: int = 400):
        super().__init__()
        self.fast_stride, self.slow_stride = fast_stride, slow_stride
        alpha = slow_stride // fast_stride
        fw = width // beta_inv

        def lateral(cin):
            return nn.Conv3d(cin, 2 * cin, (5, 1, 1), (alpha, 1, 1), (2, 0, 0), bias=False)

        self.fast_conv1 = nn.Conv3d(3, fw, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False)
        self.fast_bn1 = nn.BatchNorm3d(fw)
        self.slow_conv1 = nn.Conv3d(3, width, (1, 7, 7), (1, 2, 2), (0, 3, 3), bias=False)
        self.slow_bn1 = nn.BatchNorm3d(width)
        self.relu = nn.ReLU()
        self.pool = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.lateral_p1 = lateral(fw)
        fast_in, slow_in = fw, width + 2 * fw
        for stage, n in enumerate(stage_sizes):
            stride = 2 if stage > 0 else 1
            fast, fast_in = _stage(fast_in, (width * 2**stage) // beta_inv, n, stride, [3] * n)
            slow, slow_in = _stage(slow_in, width * 2**stage, n, stride,
                                   [3 if stage in (2, 3) else 1] * n)
            setattr(self, f"fast_res{stage + 2}", fast)
            setattr(self, f"slow_res{stage + 2}", slow)
            if stage < 3:
                setattr(self, f"lateral_res{stage + 2}", lateral(fast_in))
                slow_in += 2 * fast_in
        self.fc = nn.Linear(slow_in + fast_in, num_classes)

    def forward(self, x):
        fast = self.pool(self.relu(self.fast_bn1(self.fast_conv1(x[:, :, ::self.fast_stride]))))
        slow = self.pool(self.relu(self.slow_bn1(self.slow_conv1(x[:, :, ::self.slow_stride]))))
        slow = torch.cat([slow, self.relu(self.lateral_p1(fast))], 1)
        for stage in range(4):
            fast = getattr(self, f"fast_res{stage + 2}")(fast)
            slow = getattr(self, f"slow_res{stage + 2}")(slow)
            if stage < 3:
                slow = torch.cat([slow, self.relu(getattr(self, f"lateral_res{stage + 2}")(fast))],
                                 1)
        return self.fc(torch.cat([slow.mean((2, 3, 4)), fast.mean((2, 3, 4))], 1))


# --- the TPN repository's neck (tpn.py), its names and its forward ---------

class _ConvModule(nn.Module):
    """conv → BN → ReLU."""

    def __init__(self, cin, cout, kernel, stride, groups=1):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel, stride, _same_pad(kernel), bias=False,
                              groups=groups)
        self.bn = nn.BatchNorm3d(cout)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _TemporalModulation(nn.Module):
    def __init__(self, cin, cout, scale, groups):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, (3, 1, 1), 1, (1, 0, 0), bias=False, groups=groups)
        self.pool = nn.MaxPool3d((scale, 1, 1), (scale, 1, 1), 0, ceil_mode=True)

    def forward(self, x):
        return self.pool(self.conv(x))


class _Downampling(nn.Module):
    """The TPN repository's 'Downampling' (sic): a conv with optional BN and
    ReLU, and a max pool before or after it."""

    def __init__(self, cin, cout, kernel=(3, 1, 1), groups=1, norm=False, activation=False,
                 position="after", scale=(1, 1, 1)):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel, 1, _same_pad(kernel), bias=False,
                              groups=groups)
        self.norm = nn.BatchNorm3d(cout) if norm else None
        self.relu = nn.ReLU() if activation else None
        self.position = position
        self.pool = nn.MaxPool3d(scale, scale, 0, ceil_mode=True)

    def forward(self, x):
        if self.position == "before":
            x = self.pool(x)
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.relu is not None:
            x = self.relu(x)
        if self.position == "after":
            x = self.pool(x)
        return x


class _LevelFusion(nn.Module):
    def __init__(self, channels, mid, cout, groups):
        super().__init__()
        self.ops = nn.ModuleList([
            _Downampling(c, m, (1, 1, 1), groups, norm=True, activation=True,
                         position="before") for c, m in zip(channels, mid)])
        self.fusion_conv = nn.Sequential(nn.Conv3d(sum(mid), cout, 1, 1, 0, bias=False),
                                         nn.BatchNorm3d(cout), nn.ReLU())

    def forward(self, inputs):
        return self.fusion_conv(torch.cat([op(f) for op, f in zip(self.ops, inputs)], 1))


class _SpatialModulation(nn.Module):
    def __init__(self, inplanes, planes):
        super().__init__()
        mods = nn.ModuleList()
        for dim in inplanes:
            ds_num = int(math.log2(planes // dim)) if planes > dim else 0
            if ds_num < 1:
                mods.append(nn.Identity())
            else:
                mods.append(nn.ModuleList([
                    _ConvModule(dim * 2**i, dim * 2**(i + 1), (1, 3, 3), (1, 2, 2))
                    for i in range(ds_num)]))
        self.spatial_modulation = mods

    def forward(self, inputs):
        out = []
        for mod, feature in zip(self.spatial_modulation, inputs):
            if isinstance(mod, nn.ModuleList):
                for op in mod:
                    feature = op(feature)
            else:
                feature = mod(feature)
            out.append(feature)
        return out


class TPNNeck(nn.Module):
    """The TPN repository's neck, with its forward's list aliasing: the
    bottom-up flow reads the features that the top-down flow updated."""

    def __init__(self, in_channels, out_channels, planes, scales, groups=32):
        super().__init__()
        self.spatial_modulation = _SpatialModulation(in_channels, planes)
        self.temporal_modulation_ops = nn.ModuleList([
            _TemporalModulation(planes, out_channels, s, groups) for s in scales])
        self.downsampling_ops = nn.ModuleList([_Downampling(out_channels, out_channels)])
        self.level_fusion_op = _LevelFusion([out_channels] * 2, [out_channels] * 2, planes,
                                            groups)
        self.level_fusion_op2 = _LevelFusion([out_channels] * 2, [out_channels] * 2, planes,
                                             groups)
        self.pyramid_fusion_op = nn.Sequential(
            nn.Conv3d(planes * 2, planes, 1, 1, 0, bias=False), nn.BatchNorm3d(planes),
            nn.ReLU())

    def forward(self, inputs):
        outs = self.spatial_modulation(inputs)
        outs = [op(outs[i]) for i, op in enumerate(self.temporal_modulation_ops)]
        temporal_modulation_outs = outs  # the aliasing of the source
        for i in range(len(outs) - 1, 0, -1):
            outs[i - 1] = outs[i - 1] + outs[i]  # upsample scale (1,1,1)
        topdownouts = self.level_fusion_op2(outs)
        outs = temporal_modulation_outs
        for i in range(len(outs) - 1):
            outs[i + 1] = outs[i + 1] + self.downsampling_ops[i](outs[i])
        outs = self.level_fusion_op(outs)
        return self.pyramid_fusion_op(torch.cat([topdownouts, outs], 1))


class TPN(nn.Module):
    """gluoncv's TPN over a slow-only ResNet (tpn_resnet50_f32s2 at the
    defaults): the neck over layer3 and layer4, the head on its output."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 temporal_scales: Sequence[int] = (32, 32), num_classes: int = 400,
                 neck_groups: int = 32):
        super().__init__()
        self.conv1 = ConvBN(3, width, (1, 7, 7), (1, 2, 2))
        self.relu = nn.ReLU()
        self.pool = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        cin = width
        for stage, n in enumerate(stage_sizes):
            layer, cin = _stage(cin, width * 2**stage, n, 2 if stage > 0 else 1,
                                [3 if stage in (2, 3) else 1] * n)
            setattr(self, f"layer{stage + 1}", layer)
        self.necks = TPNNeck([width * 16, width * 32], width * 16, width * 32,
                             temporal_scales, neck_groups)
        self.fc = nn.Linear(width * 32, num_classes)

    def forward(self, x):
        x = self.pool(self.relu(self.conv1(x)))
        taps = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            taps.append(x)
        y = self.necks([taps[2], taps[3]])
        return self.fc(y.mean((2, 3, 4))), taps
