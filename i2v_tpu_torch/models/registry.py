"""Image-model registry: names, depth→tap tables, construction, weights.

PyTorch counterpart of :mod:`i2v_tpu.models.registry`: the four ENS
surrogates, DenseNet-161 and ViT-B/16. Depth indices map onto explicit tap
keys:

  resnet      depth d → stage d output            (layer{d}[-1])
  alexnet     {1:1, 2:4, 3:7, 4:11}               (features[i] ReLU)
  vgg         {1:1, 2:11, 3:20, 4:29}             (features[i] ReLU)
  squeezenet  {1:3, 2:6, 3:9, 4:12}               (Fire expand3x3 ReLU)
  densenet    depth d → dense block d output
  vit         {1:2, 2:5, 3:8, 4:11}               (transformer block outputs)

The tiny DenseNet has two dense blocks and the tiny ViT two transformer
blocks: their taps are clamped into range and deduplicated, as in the JAX
registry.

Weights: a full-width model loads ``{I2V_TPU_CKPTS}/{name}.msgpack``, the
JAX package's converted checkpoint (Flax msgpack, read by
:mod:`.checkpoint` without flax), where the file exists. The file holds the
whole network; the module, truncated at its deepest tap, takes the subset it
has. Underneath, every weight is first drawn on the CPU from a seeded
``torch.Generator`` (the same seed gives the same weights on every device),
and without a file a warning says that the model keeps those random weights.
The weights are drawn and loaded in float32 whatever the compute ``dtype``,
and rounded to it once: a bfloat16 model holds its float32 twin's weights,
rounded.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Mapping, Sequence

import torch
import torch.nn as nn

from . import densenet as _densenet
from . import resnet as _resnet
from . import vgg as _vgg
from . import vit as _vit
from .api import ImageModel
from .common import check_dtype_on_device
from .convert import checkpoint_path, from_jax_params, load_params

IMAGE_MODEL_NAMES = ("resnet", "vgg", "alexnet", "squeezenet", "densenet", "vit")

DEPTH_TO_TAP: Mapping[str, Mapping[int, int]] = {
    "resnet": {1: 1, 2: 2, 3: 3, 4: 4},
    "alexnet": {1: 1, 2: 4, 3: 7, 4: 11},
    "vgg": {1: 1, 2: 11, 3: 20, 4: 29},
    "squeezenet": {1: 3, 2: 6, 3: 9, 4: 12},
    "densenet": {1: 1, 2: 2, 3: 3, 4: 4},
    "vit": {1: 2, 2: 5, 3: 8, 4: 11},
}

# Flax's default conv/dense init (lecun_normal): a normal truncated at ±2σ,
# rescaled so that the variance is 1/fan_in.
_TRUNC_STD_CORRECTION = 0.87962566103423978


def _clamped_taps(tap_keys, hi: int, lo: int = 1) -> tuple:
    """Tap keys clamped into [lo, hi] and deduplicated in order, for the tiny
    variants with fewer stages than the full-size tap tables."""
    out: list = []
    for t in tap_keys:
        c = max(lo, min(t, hi))
        if c not in out:
            out.append(c)
    return tuple(out)


def build_image_model(name: str, depths: int | Sequence[int], *, truncate: bool = True,
                      tiny: bool = False, input_hw: int = 224,
                      dtype: torch.dtype = torch.float32):
    """Construct the module + ordered tap keys for reference-style (model
    name, depth(s)). ``tiny=True`` builds a width-reduced variant for
    checkpoint-free tests; ``dtype`` is the module's compute dtype."""
    list_depths = not isinstance(depths, int)
    if isinstance(depths, int):
        depths = [depths]
    if name not in DEPTH_TO_TAP:
        raise ValueError(f"unknown image model {name!r}; have {IMAGE_MODEL_NAMES}")
    tap_keys = tuple(sorted(DEPTH_TO_TAP[name][d] for d in depths))
    kw = dict(taps=tap_keys, truncate=truncate, dtype=dtype)
    if name == "resnet":
        module = _resnet.resnet_tiny(**kw) if tiny else _resnet.resnet101(**kw)
    elif name == "vgg":
        module = _vgg.VGG16(width_mult=0.125 if tiny else 1.0, input_hw=input_hw, **kw)
    elif name == "alexnet":
        module = _vgg.AlexNet(width_mult=0.125 if tiny else 1.0, input_hw=input_hw, **kw)
    elif name == "densenet":
        if tiny:
            # two dense blocks: depth-3/4 taps clamp onto block 2
            tap_keys = kw["taps"] = _clamped_taps(tap_keys, len(_densenet.TINY_BLOCKS))
            module = _densenet.densenet_tiny(**kw)
        else:
            module = _densenet.densenet161(**kw)
    elif name == "vit":
        if tiny:
            # clamp AND dedupe: distinct depths must not weigh one block twice
            tap_keys = kw["taps"] = _clamped_taps(tap_keys, _vit.TINY_DEPTH - 1, lo=0)
            module = _vit.vit_tiny(**kw)
        else:
            module = _vit.vit_base_patch16_224(**kw)
    else:
        # list depths (AENS) hook the whole Fire module — concat(e1,e3) —
        # where scalar depths hook the expand3x3 ReLU (TPAMI_attack.py:197-200
        # vs image_attacks.py:268-271)
        module = _vgg.SqueezeNet11(width_mult=0.25 if tiny else 1.0,
                                   fire_taps=list_depths, **kw)
    return module, tap_keys


def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every conv/linear weight from a truncated normal of variance
    1/fan_in (fan_in = I·kH·kW, or I·kT·kH·kW for a 3-D conv), in
    registration order, from ``generator``; zero the biases. Norms (DenseNet's
    frozen BN, LayerNorm) get ones and zeros, ViT's class token zeros and its
    position embedding a normal of std 0.02 from the same generator (Flax's
    initializers). The draws are float32 whatever the weights' dtype, so
    that a bfloat16 module gets its float32 twin's weights, rounded."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
                w = torch.empty(m.weight.shape, dtype=torch.float32, device=m.weight.device)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                m.weight.copy_(w)
                nn.init.zeros_(m.bias)
            elif isinstance(m, _densenet.FrozenBN):
                nn.init.ones_(m.scale)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, _vit.ViT):
                nn.init.zeros_(m.cls_token)
                nn.init.normal_(m.pos_embed, std=0.02, generator=generator)
    return module


def get_image_models(names: Sequence[str], depths: Mapping[str, int | Sequence[int]] | int,
                     *, device: torch.device | str, truncate: bool = True,
                     tiny: bool = False, input_hw: int = 224, seed: int = 0,
                     dtype: torch.dtype = torch.float32) -> list[ImageModel]:
    """Build bundles for the reference's ``get_models(model_name_lists)`` call
    sites (image_attacks.py:110-115), with depth selection attached, in eval
    mode with frozen weights, on ``device``, computing in ``dtype``."""
    check_dtype_on_device(dtype, device)
    bundles = []
    for i, name in enumerate(names):
        d = depths if isinstance(depths, int) else depths[name]
        module, tap_keys = build_image_model(name, d, truncate=truncate, tiny=tiny,
                                             input_hw=input_hw, dtype=dtype)
        random_init_(module, torch.Generator().manual_seed(seed + i))
        if not tiny:
            if os.path.exists(checkpoint_path(name)):
                from_jax_params(module, load_params(name), mode="subset")
            else:
                ckpt_dir = os.path.dirname(checkpoint_path(name))
                warnings.warn(f"no pretrained checkpoint for {name!r} under {ckpt_dir!r}; "
                              "using random init (run tools/convert_torchvision.py)")
        module = module.to(device).eval().requires_grad_(False)
        bundles.append(ImageModel(name=name, module=module, tap_keys=tap_keys))
    return bundles
