"""SlowFast networks (gluoncv ``slowfast_8x8_resnet{50,101}_kinetics400``).

PyTorch counterpart of :mod:`i2v_tpu.models.slowfast`, the same topology:
  - the model subsamples its own input on the T axis, as the gluoncv 8x8
    forward does: fast = ``x[:, :, ::2]``, slow = ``x[:, :, ::8]``, so a
    32-frame clip gives 16 fast and 4 slow frames; frames that neither
    pathway samples get exactly zero input gradient
  - fast: width β·64 = 8, a (3,1,1) conv1 in every stage, stem (5,7,7)
  - slow: width 64, (3,1,1) conv1 only in stages 3-4, stem (1,7,7)
  - lateral fast→slow fusion after pool1 and after res2, res3, res4: a
    (5,1,1) conv of stride slow_stride/fast_stride to 2βC channels, ReLU,
    concatenated onto slow (so the slow stages take 64+16, 256+64,
    512+128 and 1024+256 input channels at β=1/8)
  - head: mean of each pathway over T, H, W, concatenated [slow, fast], fc

Flax infers each layer's input width; here ``__init__`` computes it.
Submodules carry the Flax tree's names (``fast_conv1``, ``slow_res3_1``,
``lateral_p1``, ``lateral_res2``, ``fc``) for :func:`.convert.from_jax_params`.
Taps: ``slow_res{2..5}`` and ``fast_res{2..5}`` (stage outputs, NCDHW; the
slow taps are taken before the lateral concat). ``truncate`` with ``taps``
builds and runs no stage past the deepest tap and no head (logits None).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .common import Linear, deepest, set_compute_dtype
from .video_common import conv3d, max_pool3d, relu, remat_call, to_compute


class SFBottleneck(nn.Module):
    """SlowFast bottleneck: an optional (3,1,1) temporal kernel on conv1, the
    spatial stride on conv2 and on the downsample."""

    def __init__(self, in_ch: int, features: int, out_features: int, spatial_stride: int = 1,
                 temporal_kernel: int = 1, downsample: bool = False):
        super().__init__()
        st = (1, spatial_stride, spatial_stride)
        self.conv1 = conv3d(in_ch, features, (temporal_kernel, 1, 1))
        self.conv2 = conv3d(features, features, (1, 3, 3), st)
        self.conv3 = conv3d(features, out_features, (1, 1, 1))
        self.downsample = conv3d(in_ch, out_features, (1, 1, 1), st) if downsample else None

    def forward(self, x: torch.Tensor, relu_grad_scale: float = 1.0) -> torch.Tensor:
        y = relu(self.conv1(x), relu_grad_scale)
        y = relu(self.conv2(y), relu_grad_scale)
        y = self.conv3(y)
        residual = x if self.downsample is None else self.downsample(x)
        return relu(y + residual, relu_grad_scale)


class SlowFast(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), fast_stride: int = 2,
                 slow_stride: int = 8, beta_inv: int = 8, width: int = 64,
                 num_classes: int = 400, slow_temporal_stages: Sequence[int] = (2, 3),
                 remat: bool = False, taps: Sequence[str] = (), truncate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.headless = truncate and bool(taps)
        # "slow_res2" / "fast_res2" → stage 1
        depth = deepest([int(k.rsplit("res", 1)[1]) - 1 for k in taps], truncate,
                        len(stage_sizes))
        self.stage_sizes = tuple(stage_sizes)[:depth]
        self.fast_stride, self.slow_stride = fast_stride, slow_stride
        alpha = slow_stride // fast_stride
        fast_w = width // beta_inv

        def lateral(in_ch: int, out_ch: int) -> nn.Conv3d:
            return conv3d(in_ch, out_ch, (5, 1, 1), (alpha, 1, 1))

        self.fast_conv1 = conv3d(3, fast_w, (5, 7, 7), (1, 2, 2))
        self.slow_conv1 = conv3d(3, width, (1, 7, 7), (1, 2, 2))
        self.lateral_p1 = lateral(fast_w, 2 * fast_w)
        fast_in, slow_in = fast_w, width + 2 * fast_w
        for stage, n_blocks in enumerate(self.stage_sizes):
            for pathway in ("fast", "slow"):
                feats = width * 2**stage
                if pathway == "fast":
                    feats //= beta_inv
                    tk, in_ch = 3, fast_in
                else:
                    tk = 3 if stage in slow_temporal_stages else 1
                    in_ch = slow_in
                for block in range(n_blocks):
                    first = block == 0
                    self.add_module(f"{pathway}_res{stage + 2}_{block}", SFBottleneck(
                        in_ch, feats, feats * 4,
                        spatial_stride=2 if (first and stage > 0) else 1,
                        temporal_kernel=tk, downsample=first))
                    in_ch = feats * 4
                if pathway == "fast":
                    fast_in = in_ch
                else:
                    slow_in = in_ch
            if stage < min(3, len(self.stage_sizes) - 1):
                lat = 2 * (fast_w * 2**stage) * 4
                self.add_module(f"lateral_res{stage + 2}", lateral(fast_in, lat))
                slow_in += lat
        self.fc = None if self.headless else Linear(slow_in + fast_in, num_classes)
        set_compute_dtype(self, dtype)

    def _stage(self, x: torch.Tensor, pathway: str, stage: int, scale: float) -> torch.Tensor:
        for block in range(self.stage_sizes[stage]):
            # SGM: the reference's hooks skip '0.relu' names, so each stage's
            # block 0 stays unscaled (base_attacks.py:509-511)
            x = remat_call(self.remat, getattr(self, f"{pathway}_res{stage + 2}_{block}"),
                           x, 1.0 if block == 0 else scale)
        return x

    def forward(self, clip_bcthw: torch.Tensor, *, normalize: bool = True,
                relu_grad_scale: float = 1.0):
        """→ (logits, {"slow_res2": …, "fast_res2": …, …}).

        ``relu_grad_scale`` scales the backward of every ReLU but the stems',
        the laterals' and those of each stage's block 0 (gluoncv's stem and
        lateral activations are not named '*relu*', so the reference's SGM
        hooks never reach them)."""
        x = to_compute(clip_bcthw, normalize, self.dtype)
        fast = relu(self.fast_conv1(x[:, :, ::self.fast_stride]))
        fast = max_pool3d(fast, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        slow = relu(self.slow_conv1(x[:, :, ::self.slow_stride]))
        slow = max_pool3d(slow, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        slow = torch.cat([slow, relu(self.lateral_p1(fast))], dim=1)
        taps = {}
        n = len(self.stage_sizes)
        for stage in range(n):
            fast = self._stage(fast, "fast", stage, relu_grad_scale)
            slow = self._stage(slow, "slow", stage, relu_grad_scale)
            taps[f"fast_res{stage + 2}"] = fast
            taps[f"slow_res{stage + 2}"] = slow
            if stage < min(3, n - 1):
                lat = relu(getattr(self, f"lateral_res{stage + 2}")(fast))
                slow = torch.cat([slow, lat], dim=1)
        if self.headless:
            return None, taps
        pooled = torch.cat([slow.mean(dim=(2, 3, 4)), fast.mean(dim=(2, 3, 4))], dim=1)
        return self.fc(pooled).float(), taps


def slowfast_resnet50(**kw) -> SlowFast:
    return SlowFast(stage_sizes=(3, 4, 6, 3), **kw)


def slowfast_resnet101(**kw) -> SlowFast:
    return SlowFast(stage_sizes=(3, 4, 23, 3), **kw)


def slowfast_tiny(**kw) -> SlowFast:
    """Width-8 variant for checkpoint-free tests. Stage 2 has two blocks so
    that SGM's scaling (which skips block 0) shows; fast keeps every frame so
    that short test clips stay non-degenerate."""
    return SlowFast(stage_sizes=(1, 2, 1, 1), width=8, beta_inv=4, fast_stride=1,
                    slow_stride=4, num_classes=10, **kw)
