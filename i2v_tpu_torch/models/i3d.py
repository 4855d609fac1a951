"""I3D ResNet with non-local blocks (gluoncv ``i3d_nl5_resnet{50,101}_v1_kinetics400``).

PyTorch counterpart of :mod:`i2v_tpu.models.i3d`, the same topology:
  - stem: Conv3d 64 (5,7,7)/(2,2,2), pool (1,3,3)/(1,2,2) padded (0,1,1)
  - pool (2,1,1)/(2,1,1) after res-layer 1 (temporal 16→8 on 32-frame clips)
  - 4 bottleneck stages, spatial strides (1,2,2,2); '3x1x1' inflation at the
    per-stage frequencies below; 5 non-local blocks after blocks (1,3) of
    stage 2 and (1,3,5) of stage 3
  - head: mean over T, H, W → fc(400)

Submodules carry the Flax tree's names (``conv1``, ``layer2_1``,
``layer2_1_nl.theta``, ``fc``), so that :func:`.convert.from_jax_params`
maps them by name. Taps: ``res_layer{i}`` (stage outputs, NCDHW).
``truncate`` with ``taps`` builds and runs no stage past the deepest tap
and no head (the logits are None), as the JAX model's unused layers are
dead code under jit.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .common import Linear, deepest, set_compute_dtype
from .video_common import (Bottleneck3D, NonLocal3D, conv3d, max_pool3d, relu, remat_call,
                           to_compute)

# '3x1x1' inflation frequency per stage (mmaction i3d defaults)
_INFLATE_R50 = ((1, 1, 1), (1, 0, 1, 0), (1, 0, 1, 0, 1, 0), (0, 1, 0))
_INFLATE_R101 = ((1, 1, 1), (1, 0, 1, 0), tuple((1, 0) * 12)[:23], (0, 1, 0))
# non-local block positions (after these block indices), per stage
_NL5 = ((), (1, 3), (1, 3, 5), ())


class I3DResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 inflate_freq: Sequence[Sequence[int]] = _INFLATE_R50,
                 nonlocal_pos: Sequence[Sequence[int]] = _NL5, nl_sub_sample: bool = True,
                 nl_type: str = "gaussian", width: int = 64, num_classes: int = 400,
                 remat: bool = False, taps: Sequence[str] = (), truncate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # remat the stem too: its pre-pool activation is the model's largest
        self.remat = remat
        self.nonlocal_pos = tuple(tuple(p) for p in nonlocal_pos)
        self.headless = truncate and bool(taps)
        depth = deepest([int(k[len("res_layer"):]) for k in taps], truncate, len(stage_sizes))
        self.stage_sizes = tuple(stage_sizes)[:depth]
        self.conv1 = conv3d(3, width, (5, 7, 7), (2, 2, 2))
        in_ch = width
        for stage, n_blocks in enumerate(self.stage_sizes):
            feats = width * 2**stage
            for block in range(n_blocks):
                first = block == 0
                self.add_module(f"layer{stage + 1}_{block}", Bottleneck3D(
                    in_ch, feats, spatial_stride=2 if (first and stage > 0) else 1,
                    downsample=first, inflate=bool(inflate_freq[stage][block])))
                in_ch = feats * 4
                if block in self.nonlocal_pos[stage]:
                    self.add_module(f"layer{stage + 1}_{block}_nl",
                                    NonLocal3D(in_ch, sub_sample=nl_sub_sample, nl_type=nl_type))
        self.fc = None if self.headless else Linear(in_ch, num_classes)
        set_compute_dtype(self, dtype)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool3d(relu(self.conv1(x)), (1, 3, 3), (1, 2, 2), (0, 1, 1))

    def forward(self, clip_bcthw: torch.Tensor, *, normalize: bool = True,
                relu_grad_scale: float = 1.0):
        """→ (logits, {"res_layer1": …, …, "res_layer4": …}).

        ``normalize`` applies ImageNet normalization to a [0,1] clip (off for
        an already normalized one). ``relu_grad_scale`` scales the backward
        of every ReLU but the stem's and those of each stage's block 0, as
        the reference's name-filtered SGM hooks do (base_attacks.py:509-511)."""
        x = to_compute(clip_bcthw, normalize, self.dtype)
        x = remat_call(self.remat, self._stem, x)
        taps = {}
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                scale = 1.0 if block == 0 else relu_grad_scale
                x = remat_call(self.remat, getattr(self, f"layer{stage + 1}_{block}"), x, scale)
                if block in self.nonlocal_pos[stage]:
                    x = getattr(self, f"layer{stage + 1}_{block}_nl")(x)
            taps[f"res_layer{stage + 1}"] = x
            if stage == 0 and stage + 1 < len(self.stage_sizes):
                x = max_pool3d(x, (2, 1, 1), (2, 1, 1))
        if self.headless:
            return None, taps
        return self.fc(x.mean(dim=(2, 3, 4))).float(), taps


def i3d_resnet50(**kw) -> I3DResNet:
    return I3DResNet(stage_sizes=(3, 4, 6, 3), inflate_freq=_INFLATE_R50, **kw)


def i3d_resnet101(**kw) -> I3DResNet:
    return I3DResNet(stage_sizes=(3, 4, 23, 3), inflate_freq=_INFLATE_R101, **kw)


def i3d_tiny(**kw) -> I3DResNet:
    """Width-8 variant for checkpoint-free tests. Stage 2 has two blocks so
    that SGM's ReLU gradient scaling (which skips every block 0) shows."""
    return I3DResNet(stage_sizes=(1, 2, 1, 1), inflate_freq=((1,), (1, 0), (1,), (0,)),
                     nonlocal_pos=((), (0,), (), ()), width=8, num_classes=10, **kw)
