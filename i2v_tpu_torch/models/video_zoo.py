"""Video-model registry: the reference's six model names (utils.py:8-15),
their builders and tap tables.

PyTorch counterpart of :mod:`i2v_tpu.models.video_zoo`: I3D, SlowFast and
TPN, each at ResNet-50 and ResNet-101 depth. Weights: a full-width model
loads ``{I2V_TPU_CKPTS}/{name}[_ucf101].msgpack``, the JAX package's
checkpoint converted from gluoncv (Flax msgpack, read by :mod:`.checkpoint`
without flax), where the file exists. The file is laid over the random init
that is drawn first, on the CPU from a seeded ``torch.Generator`` (the same
seed gives the same weights on every device): a file that covers only part
of the model loads, and a warning names the modules it left at random init.
Without a file a warning says that the model keeps its random weights.
A model of another compute ``dtype`` is drawn and loaded in float32 and then
cast (:func:`.common.set_compute_dtype`): checkpoint files hold float32
arrays only, and the bfloat16 model holds its float32 twin's weights,
rounded.
"""

from __future__ import annotations

import os
import warnings

import torch

from . import i3d, slowfast, tpn
from .api import VideoModel
from .common import check_dtype_on_device, set_compute_dtype
from .convert import checkpoint_path, from_jax_params, load_params, missing_modules
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
                    ucf101: bool = False, remat: bool = False, seed: int = 0,
                    dtype: torch.dtype = torch.float32, taps=None,
                    truncate: bool = False) -> VideoModel:
    """Build a video-model bundle for a reference model name, in eval mode
    with frozen weights (no weight gradient ever runs), on ``device``,
    computing in ``dtype``. ``ucf101=True`` gives the 101-class head of the
    fine-tuned models at full width (reference_ucf101.py:107-117); the tiny
    models keep 10 classes. ``remat=True`` recomputes the bottlenecks (and
    I3D's stem) in backward passes instead of keeping their activations.
    ``taps`` are the bundle's tap keys (default: TAP's, ``tap_keys_for``);
    ``truncate=True`` builds and runs nothing past the deepest of them and
    no head, as the image registry's ``truncate`` (ILAF's model: the JAX
    package's jit drops those layers as dead code). The weights of the
    layers it keeps are the full model's: the random init draws them first,
    and a checkpoint file is laid over what exists."""
    if name not in VIDEO_BUILDERS:
        raise ValueError(f"unknown video model {name!r}; have {sorted(VIDEO_BUILDERS)}")
    check_dtype_on_device(dtype, device)
    taps = tap_keys_for(name, "tap") if taps is None else tuple(taps)
    kw = {"remat": remat, "taps": taps, "truncate": truncate}
    if ucf101 and not tiny:
        kw["num_classes"] = 101
    module = (TINY_BUILDERS if tiny else VIDEO_BUILDERS)[name](**kw)
    random_init_(module, torch.Generator().manual_seed(seed))
    if not tiny:
        _load_checkpoint(module, name, ucf101)
    module = set_compute_dtype(module, dtype).to(device).eval().requires_grad_(False)
    return VideoModel(name=name, module=module, tap_keys=taps)


def _load_checkpoint(module, name: str, ucf101: bool) -> None:
    """Lay ``{name}[_ucf101].msgpack`` over ``module``'s init where the file
    exists, with the JAX package's warnings (``video_zoo.py:110-128``)."""
    ckpt = f"{name}_ucf101" if ucf101 else name
    if not os.path.exists(checkpoint_path(ckpt)):
        warnings.warn(f"no converted checkpoint for {name!r}"
                      f"{' (ucf101)' if ucf101 else ''}; using random init "
                      "(run tools/convert_gluoncv.py)")
        return
    params = load_params(ckpt)
    from_jax_params(module, params, mode="overlay")
    missing = missing_modules(module, params)
    if missing:
        warnings.warn(f"checkpoint for {name!r} left {len(missing)} module(s) at random init: "
                      f"{missing[:8]}{'…' if len(missing) > 8 else ''} — transfer numbers "
                      "are NOT valid until these convert (see convert_gluoncv --report)")
