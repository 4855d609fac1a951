"""Temporal Pyramid Network (gluoncv ``tpn_resnet{50,101}_f32s2_kinetics400``).

PyTorch counterpart of :mod:`i2v_tpu.models.tpn`, the same topology:
  - backbone: a slow-only inflated ResNet, stem (1,7,7), (3,1,1) conv1
    kernels in stages 3-4, no temporal downsampling; stages ``layer1..4``
  - neck over layer3 (fine, 16w channels) and layer4 (coarse, 32w):
      spatial modulation   layer3: (1,3,3)/(1,2,2) conv 16w→32w + ReLU;
                           layer4: identity
      temporal modulation  per level: grouped (3,1,1) conv, groups=32,
                           32w→16w, then a ceil-mode temporal max pool
      top-down flow        fine += nearest-upsample(coarse)
      level fusion 2       per level: grouped 1×1×1 conv + ReLU → concat →
                           1×1×1 fusion conv + ReLU → 32w
      bottom-up flow       coarse += (3,1,1) conv (fine), no activation
      level fusion 1       as level fusion 2
      pyramid fusion       concat(top-down, bottom-up) → 1×1×1 conv + ReLU
  - head: mean over T, H, W → fc

As in the TPN repository, the bottom-up flow reads the top-down-*mutated*
``fine`` (its list aliasing), not the temporal modulation's output.

Submodules carry the Flax tree's names (``conv1``, ``layer3_0``, ``sm_0_0``,
``tm_0``, ``lf2_op1``, ``down_0``, ``pyramid``, ``fc``) for
:func:`.convert.from_jax_params`. Taps: ``layer{1..4}`` (NCDHW).
``truncate`` with ``taps`` builds and runs no stage past the deepest tap, no
neck and no head (logits None).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Linear, deepest, set_compute_dtype
from .video_common import conv3d, max_pool3d, relu, remat_call, to_compute


class TPNBottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, spatial_stride: int = 1,
                 temporal_kernel: int = 1, downsample: bool = False):
        super().__init__()
        st = (1, spatial_stride, spatial_stride)
        self.conv1 = conv3d(in_ch, features, (temporal_kernel, 1, 1))
        self.conv2 = conv3d(features, features, (1, 3, 3), st)
        self.conv3 = conv3d(features, features * 4, (1, 1, 1))
        self.downsample = conv3d(in_ch, features * 4, (1, 1, 1), st) if downsample else None

    def forward(self, x: torch.Tensor, relu_grad_scale: float = 1.0) -> torch.Tensor:
        y = relu(self.conv1(x), relu_grad_scale)
        y = relu(self.conv2(y), relu_grad_scale)
        y = self.conv3(y)
        residual = x if self.downsample is None else self.downsample(x)
        return relu(y + residual, relu_grad_scale)


def _pool_t_ceil(x: torch.Tensor, scale: int) -> torch.Tensor:
    """``MaxPool3d((s,1,1), (s,1,1), ceil_mode=True)`` over the T axis of an
    NCDHW tensor: the last window is clipped where T is not a multiple of s."""
    if scale <= 1:
        return x
    return F.max_pool3d(x, (scale, 1, 1), (scale, 1, 1), ceil_mode=True)


class TPN(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 num_classes: int = 400, temporal_stages: Sequence[int] = (2, 3),
                 temporal_scales: Sequence[int] = (32, 32), upsample_scale: int = 1,
                 neck_groups: int = 32, remat: bool = False, taps: Sequence[str] = (),
                 truncate: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.headless = truncate and bool(taps)
        depth = deepest([int(k[len("layer"):]) for k in taps], truncate, len(stage_sizes))
        self.stage_sizes = tuple(stage_sizes)[:depth]
        self.temporal_scales = tuple(temporal_scales)
        self.upsample_scale = upsample_scale
        self.conv1 = conv3d(3, width, (1, 7, 7), (1, 2, 2))
        in_ch = width
        for stage, n_blocks in enumerate(self.stage_sizes):
            feats = width * 2**stage
            for block in range(n_blocks):
                first = block == 0
                self.add_module(f"layer{stage + 1}_{block}", TPNBottleneck(
                    in_ch, feats, spatial_stride=2 if (first and stage > 0) else 1,
                    temporal_kernel=3 if stage in temporal_stages else 1, downsample=first))
                in_ch = feats * 4
        if self.headless:
            set_compute_dtype(self, dtype)
            return
        planes = width * 32   # spatial-modulation target channels
        out_c = width * 16    # the neck's out_channels
        g = neck_groups
        self.sm_0_0 = conv3d(width * 16, planes, (1, 3, 3), (1, 2, 2))
        self.tm_0 = conv3d(planes, out_c, (3, 1, 1), groups=g)
        self.tm_1 = conv3d(in_ch, out_c, (3, 1, 1), groups=g)
        for prefix in ("lf2", "lf1"):
            for i in range(2):
                self.add_module(f"{prefix}_op{i}", conv3d(out_c, out_c, (1, 1, 1), groups=g))
            self.add_module(f"{prefix}_fusion", conv3d(2 * out_c, planes, (1, 1, 1)))
        self.down_0 = conv3d(out_c, out_c, (3, 1, 1))
        self.pyramid = conv3d(2 * planes, planes, (1, 1, 1))
        self.fc = Linear(planes, num_classes)
        set_compute_dtype(self, dtype)

    def _level_fusion(self, prefix: str, levels, scale: float) -> torch.Tensor:
        # under the reference's SGM name filter only `ops.1.relu` matches
        # ('0.relu' is excluded, the fusion ReLU has a numeric name), so the
        # coarse level's ReLU alone is grad-scaled
        fused = [relu(getattr(self, f"{prefix}_op{i}")(f), scale if i > 0 else 1.0)
                 for i, f in enumerate(levels)]
        return relu(getattr(self, f"{prefix}_fusion")(torch.cat(fused, dim=1)))

    def forward(self, clip_bcthw: torch.Tensor, *, normalize: bool = True,
                relu_grad_scale: float = 1.0):
        """→ (logits, {"layer1": …, …, "layer4": …}).

        ``relu_grad_scale`` scales the stem's ReLU too: the TPN repository
        names its stem activation ``relu``, so the reference's SGM hook
        (base_attacks.py:509-511) reaches it, unlike I3D's and SlowFast's.
        Block-0 ReLUs and the neck's, but for the coarse level fusion's, stay
        unscaled."""
        s = relu_grad_scale
        x = to_compute(clip_bcthw, normalize, self.dtype)
        x = max_pool3d(relu(self.conv1(x), s), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        taps, feats = {}, []
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                x = remat_call(self.remat, getattr(self, f"layer{stage + 1}_{block}"),
                               x, 1.0 if block == 0 else s)
            taps[f"layer{stage + 1}"] = x
            feats.append(x)
        if self.headless:
            return None, taps

        fine = relu(self.sm_0_0(feats[2]))
        coarse = feats[3]
        fine = _pool_t_ceil(self.tm_0(fine), self.temporal_scales[0])
        coarse = _pool_t_ceil(self.tm_1(coarse), self.temporal_scales[1])
        up = coarse.repeat_interleave(self.upsample_scale, dim=2) \
            if self.upsample_scale > 1 else coarse
        fine = fine + up
        topdown = self._level_fusion("lf2", [fine, coarse], s)
        coarse = coarse + self.down_0(fine)   # on the top-down-mutated fine
        bottomup = self._level_fusion("lf1", [fine, coarse], s)
        y = relu(self.pyramid(torch.cat([topdown, bottomup], dim=1)))
        return self.fc(y.mean(dim=(2, 3, 4))).float(), taps


def tpn_resnet50(**kw) -> TPN:
    return TPN(stage_sizes=(3, 4, 6, 3), **kw)


def tpn_resnet101(**kw) -> TPN:
    return TPN(stage_sizes=(3, 4, 23, 3), **kw)


def tpn_tiny(**kw) -> TPN:
    """Width-8 variant for checkpoint-free tests; stage 2 has two blocks so
    that SGM's scaling (which skips block 0) shows."""
    return TPN(stage_sizes=(1, 2, 1, 1), width=8, temporal_scales=(2, 2), num_classes=10, **kw)
