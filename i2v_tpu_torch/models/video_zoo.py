"""Video-model registry: the reference's six model names (utils.py:8-15),
their builders and tap tables.

PyTorch counterpart of :mod:`i2v_tpu.models.video_zoo`: I3D, SlowFast and
TPN, each at ResNet-50 and ResNet-101 depth. Weights: the port loads no
checkpoints yet (the JAX package's are Flax msgpack files converted from
gluoncv), so weights are random, drawn on the CPU from a seeded
``torch.Generator`` (the same seed gives the same weights on every device);
at full width a warning says so.
"""

from __future__ import annotations

import warnings

import torch

from . import i3d, slowfast, tpn
from .api import VideoModel
from .registry import random_init_

VIDEO_BUILDERS = {
    "i3d_resnet50": i3d.i3d_resnet50,
    "i3d_resnet101": i3d.i3d_resnet101,
    "slowfast_resnet50": slowfast.slowfast_resnet50,
    "slowfast_resnet101": slowfast.slowfast_resnet101,
    "tpn_resnet50": tpn.tpn_resnet50,
    "tpn_resnet101": tpn.tpn_resnet101,
}
TINY_BUILDERS = {
    "i3d_resnet50": i3d.i3d_tiny,
    "i3d_resnet101": i3d.i3d_tiny,
    "slowfast_resnet50": slowfast.slowfast_tiny,
    "slowfast_resnet101": slowfast.slowfast_tiny,
    "tpn_resnet50": tpn.tpn_tiny,
    "tpn_resnet101": tpn.tpn_tiny,
}

# per-architecture target layers (reference: base_attacks.py:737-743)
TAP_TAPS = {
    "i3d": ("res_layer1", "res_layer2"),
    "slowfast": ("slow_res2", "slow_res3", "fast_res2", "fast_res3"),
    "tpn": ("layer1", "layer2"),
}
# ILAF mid-layers (reference: image_attacks.py:513-519)
ILAF_TAPS = {
    "i3d": ("res_layer2",),
    "slowfast": ("slow_res2", "fast_res2"),
    "tpn": ("layer2",),
}


def tap_keys_for(model_name: str, purpose: str = "tap") -> tuple:
    table = TAP_TAPS if purpose == "tap" else ILAF_TAPS
    return table[model_name.split("_")[0]]


def get_video_model(name: str, *, device: torch.device | str, tiny: bool = False,
                    ucf101: bool = False, remat: bool = False, seed: int = 0) -> VideoModel:
    """Build a video-model bundle for a reference model name, in eval mode
    with frozen weights (no weight gradient ever runs), on ``device``.
    ``ucf101=True`` gives the 101-class head of the fine-tuned models at full
    width (reference_ucf101.py:107-117); the tiny models keep 10 classes.
    ``remat=True`` recomputes the bottlenecks (and I3D's stem) in backward
    passes instead of keeping their activations."""
    if name not in VIDEO_BUILDERS:
        raise ValueError(f"unknown video model {name!r}; have {sorted(VIDEO_BUILDERS)}")
    kw = {"remat": remat}
    if ucf101 and not tiny:
        kw["num_classes"] = 101
    module = (TINY_BUILDERS if tiny else VIDEO_BUILDERS)[name](**kw)
    if not tiny:
        warnings.warn(f"no pretrained checkpoint for {name!r}"
                      f"{' (ucf101)' if ucf101 else ''}: the port loads none yet; "
                      "using random init")
    random_init_(module, torch.Generator().manual_seed(seed))
    module = module.to(device).eval().requires_grad_(False)
    return VideoModel(name=name, module=module, tap_keys=tap_keys_for(name, "tap"))
