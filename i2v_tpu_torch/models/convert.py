"""Weight converters into the port's modules.

``from_jax_params`` loads the JAX package's Flax parameter tree
(``{"params": {...}}`` of numpy arrays) into a port module: the module names
its submodules as the Flax tree names them, so a parameter ``a.b.weight``
comes from ``params["a"]["b"]["kernel"]`` (``["scale"]`` for a LayerNorm)
and ``a.b.bias`` from ``params["a"]["b"]["bias"]``; any other name passes
through (DenseNet's ``scale``, ViT's top-level ``cls_token`` and
``pos_embed``). Layouts change on the way:

  conv kernel  (kH, kW, I, O) → (O, I, kH, kW)
  3-D conv kernel (kT, kH, kW, I, O) → (O, I, kT, kH, kW)
  dense kernel (I, O)         → (O, I)
  dense kernel fed by a flatten: the input index runs over H·W·C in the JAX
  package and over C·H·W here (the inverse of
  :func:`dense_kernel_from_flatten`).
  1-D and 3-D leaves (biases, scales, ViT's token and position embeddings)
  pass through untransposed.

By default every port parameter must get a value and every Flax leaf must
be used. ``mode="subset"`` lets the file hold more than the module (a
whole-network surrogate file loaded into a module truncated at its deepest
tap), and ``mode="overlay"`` lets it hold less (a partial video-model file
over the module's random init), as the JAX package applies such files.
``to_jax_params`` is the inverse, and ``save_params``/``load_params`` write
and read the JAX package's ``{I2V_TPU_CKPTS}/{name}.msgpack`` files
(``{"params": tree}`` in Flax's msgpack format, :mod:`.checkpoint`) with
neither flax nor msgpack installed.

``convert_swin3d`` maps the published Video Swin checkpoint (mmaction's
layout, ``backbone.*`` and ``cls_head.fc_cls.*``) onto the port's
:mod:`.swin3d` names, which the video registry lays over the random init
from ``{I2V_TPU_CKPTS}/swin3d_b.pth``; ``convert_mvit`` maps PySlowFast's
MViTv2 checkpoint (``model_state``) onto :mod:`.mvit`, from
``{I2V_TPU_CKPTS}/mvit_v2_b.pyth``; ``convert_uniformer`` maps Sense-X's
UniFormer checkpoint onto :mod:`.uniformer`, from
``{I2V_TPU_CKPTS}/uniformer_b.pth``.

The checkpoint converters are here too, the counterparts of
``i2v_tpu.models.convert`` without flax: ``convert_resnet``,
``convert_vgg16``, ``convert_alexnet``, ``convert_squeezenet11``,
``convert_densenet161`` and ``convert_vit_b16`` turn a torchvision (timm
for ViT) state_dict into the JAX package's Flax tree, BatchNorm folded into
the preceding conv (``fold_bn``: W' = W·γ/√(σ²+ε) per out-channel,
b' = β − μ·γ/√(σ²+ε) + b·γ/√(σ²+ε)), DenseNet's pre-activation BNs as
FrozenBN affines. The tree is the JAX converter's, key for key, dtype for
dtype and bit for bit (the same arithmetic in the same order), so that
``convert_torchvision`` writes the file ``tools/convert_torchvision.py``
writes, byte for byte. ``tools/torch_convert_torchvision.py`` and
``tools/torch_convert_gluoncv.py`` are the command lines.

Runner state crosses too, both ways, exactly: the frame-batch modifier
(``modifier_from_jax``/``modifier_to_jax``: the JAX runner's (B·T, H, W, 3)
against the port's (B·T, 3, H, W)) and the Adam state
(``adam_state_from_jax``/``adam_state_to_jax``: optax's ``(count int32, mu,
nu)`` against torch Adam's ``(step float32, exp_avg, exp_avg_sq)``), so that
a segment of one package's runner can seed the other's. numpy has no
bfloat16 (without ``ml_dtypes``), so a bfloat16 tensor (a model's weights, a
``mu_dtype`` first moment) goes out as a float32 array that holds its
bfloat16 values, exactly, and comes back as float32 for the caller to cast.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from . import checkpoint
from .uniformer import UNIFORMER_B

BN_EPS = 1e-5
FROM_JAX_MODES = ("strict", "subset", "overlay")


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def fold_bn(conv_w: np.ndarray, conv_b: Optional[np.ndarray], bn: Mapping,
            prefix: str) -> tuple[np.ndarray, np.ndarray]:
    """Fold a BN layer (torch names ``{prefix}.weight/bias/running_mean/
    running_var``) into the preceding conv's (O, ...) weight + bias:
    W' = W·γ/√(σ²+ε) per out-channel, b' = β − μ·γ/√(σ²+ε) + b·γ/√(σ²+ε)."""
    gamma = _np(bn[f"{prefix}.weight"])
    beta = _np(bn[f"{prefix}.bias"])
    mean = _np(bn[f"{prefix}.running_mean"])
    var = _np(bn[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    shape = (-1,) + (1,) * (conv_w.ndim - 1)
    w = conv_w * scale.reshape(shape)
    b = beta - mean * scale
    if conv_b is not None:
        b = b + conv_b * scale
    return w, b


# ---------------------------------------------------------------------------
# torch layouts → the JAX package's Flax layouts
# ---------------------------------------------------------------------------

def conv2d_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I, kH, kW) → (kH, kW, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def conv3d_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I, kT, kH, kW) → (kT, kH, kW, I, O)."""
    return np.transpose(w, (2, 3, 4, 1, 0))


def dense_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I) → (I, O)."""
    return np.transpose(w, (1, 0))


def dense_kernel_from_flatten(w: np.ndarray, chw: tuple[int, int, int]) -> np.ndarray:
    """Dense fed by a flatten: torch's C·H·W input order → the JAX package's
    H·W·C. w: (O, C·H·W) → (H·W·C, O)."""
    o = w.shape[0]
    c, h, ww = chw
    w = w.reshape(o, c, h, ww).transpose(0, 2, 3, 1).reshape(o, h * ww * c)
    return np.transpose(w, (1, 0))


def _conv_entry(sd, name: str, bn_name: Optional[str] = None,
                three_d: bool = False) -> dict:
    w = _np(sd[f"{name}.weight"])
    b = _np(sd[f"{name}.bias"]) if f"{name}.bias" in sd else None
    if bn_name is not None:
        w, b = fold_bn(w, b, sd, bn_name)
    kernel = conv3d_kernel(w) if three_d else conv2d_kernel(w)
    if b is None:
        b = np.zeros(kernel.shape[-1], np.float32)
    return {"kernel": kernel.astype(np.float32), "bias": b.astype(np.float32)}


def _dense_entry(sd, name: str, flatten_chw=None) -> dict:
    w = _np(sd[f"{name}.weight"])
    kernel = (dense_kernel_from_flatten(w, flatten_chw) if flatten_chw
              else dense_kernel(w))
    return {"kernel": kernel.astype(np.float32),
            "bias": _np(sd[f"{name}.bias"]).astype(np.float32)}


def _frozen_bn_entry(sd, prefix: str) -> dict:
    """A pre-activation BN → a FrozenBN affine (scale, bias)."""
    gamma = _np(sd[f"{prefix}.weight"])
    beta = _np(sd[f"{prefix}.bias"])
    mean = _np(sd[f"{prefix}.running_mean"])
    var = _np(sd[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"scale": scale.astype(np.float32),
            "bias": (beta - mean * scale).astype(np.float32)}


# ---------------------------------------------------------------------------
# torchvision (and timm) image models
# ---------------------------------------------------------------------------

def convert_resnet(sd, stage_sizes=(3, 4, 23, 3)) -> dict:
    """torchvision resnet50/101 → the ResNet tree."""
    p = {"stem": _conv_entry(sd, "conv1", "bn1")}
    for stage in range(4):
        for block in range(stage_sizes[stage]):
            t = f"layer{stage + 1}.{block}"
            entry = {
                "conv1": _conv_entry(sd, f"{t}.conv1", f"{t}.bn1"),
                "conv2": _conv_entry(sd, f"{t}.conv2", f"{t}.bn2"),
                "conv3": _conv_entry(sd, f"{t}.conv3", f"{t}.bn3"),
            }
            if f"{t}.downsample.0.weight" in sd:
                entry["downsample"] = _conv_entry(
                    sd, f"{t}.downsample.0", f"{t}.downsample.1")
            p[f"layer{stage + 1}_{block}"] = entry
    p["fc"] = _dense_entry(sd, "fc")
    return p


_VGG_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def convert_vgg16(sd) -> dict:
    p = {f"conv{i}": _conv_entry(sd, f"features.{i}") for i in _VGG_CONV_IDX}
    p["fc1"] = _dense_entry(sd, "classifier.0", flatten_chw=(512, 7, 7))
    p["fc2"] = _dense_entry(sd, "classifier.3")
    p["fc3"] = _dense_entry(sd, "classifier.6")
    return p


_ALEXNET_CONV_IDX = (0, 3, 6, 8, 10)


def convert_alexnet(sd) -> dict:
    p = {f"conv{i}": _conv_entry(sd, f"features.{i}") for i in _ALEXNET_CONV_IDX}
    p["fc1"] = _dense_entry(sd, "classifier.1", flatten_chw=(256, 6, 6))
    p["fc2"] = _dense_entry(sd, "classifier.4")
    p["fc3"] = _dense_entry(sd, "classifier.6")
    return p


_SQUEEZENET_FIRE_IDX = (3, 4, 6, 7, 9, 10, 11, 12)


def convert_squeezenet11(sd) -> dict:
    p = {"conv0": _conv_entry(sd, "features.0")}
    for i in _SQUEEZENET_FIRE_IDX:
        p[f"fire{i}"] = {
            "squeeze": _conv_entry(sd, f"features.{i}.squeeze"),
            "expand1x1": _conv_entry(sd, f"features.{i}.expand1x1"),
            "expand3x3": _conv_entry(sd, f"features.{i}.expand3x3"),
        }
    p["classifier"] = _conv_entry(sd, "classifier.1")
    return p


def convert_densenet161(sd, block_config=(6, 12, 36, 24)) -> dict:
    """torchvision densenet161 → the DenseNet tree. Pre-activation BNs
    become FrozenBN affines (no fold through the ReLU between)."""
    f = "features"
    p = {
        "conv0": _conv_entry(sd, f"{f}.conv0"),
        "norm0": _frozen_bn_entry(sd, f"{f}.norm0"),
        "norm5": _frozen_bn_entry(sd, f"{f}.norm5"),
        "classifier": _dense_entry(sd, "classifier"),
    }
    for i, layers in enumerate(block_config):
        for j in range(1, layers + 1):
            base = f"{f}.denseblock{i + 1}.denselayer{j}"
            p[f"denseblock{i + 1}_layer{j}"] = {
                "norm1": _frozen_bn_entry(sd, f"{base}.norm1"),
                "conv1": _conv_entry(sd, f"{base}.conv1"),
                "norm2": _frozen_bn_entry(sd, f"{base}.norm2"),
                "conv2": _conv_entry(sd, f"{base}.conv2"),
            }
        if i + 1 < len(block_config):
            p[f"transition{i + 1}"] = {
                "norm": _frozen_bn_entry(sd, f"{f}.transition{i + 1}.norm"),
                "conv": _conv_entry(sd, f"{f}.transition{i + 1}.conv"),
            }
    return p


def convert_vit_b16(sd) -> dict:
    """timm vit_base_patch16_224 → the ViT tree. The patch embedding, the
    tokens and the LayerNorms keep the source's dtype, as the JAX
    converter keeps it."""
    p = {
        "patch_embed": {
            "kernel": conv2d_kernel(_np(sd["patch_embed.proj.weight"])),
            "bias": _np(sd["patch_embed.proj.bias"]),
        },
        "cls_token": _np(sd["cls_token"]),
        "pos_embed": _np(sd["pos_embed"]),
        "norm": {"scale": _np(sd["norm.weight"]), "bias": _np(sd["norm.bias"])},
        "head": _dense_entry(sd, "head"),
    }
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        b = f"blocks.{i}"
        p[f"block{i}"] = {
            "norm1": {"scale": _np(sd[f"{b}.norm1.weight"]),
                      "bias": _np(sd[f"{b}.norm1.bias"])},
            "attn": {"qkv": _dense_entry(sd, f"{b}.attn.qkv"),
                     "proj": _dense_entry(sd, f"{b}.attn.proj")},
            "norm2": {"scale": _np(sd[f"{b}.norm2.weight"]),
                      "bias": _np(sd[f"{b}.norm2.bias"])},
            "fc1": _dense_entry(sd, f"{b}.mlp.fc1"),
            "fc2": _dense_entry(sd, f"{b}.mlp.fc2"),
        }
        i += 1
    return p


IMAGE_CONVERTERS = {
    "resnet": lambda sd: convert_resnet(sd, (3, 4, 23, 3)),
    "resnet50": lambda sd: convert_resnet(sd, (3, 4, 6, 3)),
    "vgg": convert_vgg16,
    "alexnet": convert_alexnet,
    "squeezenet": convert_squeezenet11,
    "densenet": convert_densenet161,
    "vit": convert_vit_b16,
}


def convert_torchvision(name: str, state_dict, ckpt_dir: Optional[str] = None) -> str:
    """Convert a torchvision image-model state_dict and write it to
    ``{ckpt_dir or $I2V_TPU_CKPTS or ./checkpoints}/{name}.msgpack``."""
    return save_params(IMAGE_CONVERTERS[name](state_dict), name, ckpt_dir)


# ---------------------------------------------------------------------------
# the JAX package's tree → a port module, and back
# ---------------------------------------------------------------------------

def _flatten_leaves(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten_leaves(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _to_port_layout(name: str, w: np.ndarray, flatten_fed: Mapping[str, tuple]) -> np.ndarray:
    if w.ndim == 5:
        return np.transpose(w, (4, 3, 0, 1, 2))
    if w.ndim == 4:
        return np.transpose(w, (3, 2, 0, 1))
    if w.ndim == 2:
        owner = name.rsplit(".", 1)[0]
        if owner in flatten_fed:
            c, h, ww = flatten_fed[owner]
            o = w.shape[1]
            return w.T.reshape(o, h, ww, c).transpose(0, 3, 1, 2).reshape(o, c * h * ww)
        return w.T
    return w


def _scale_owners(module: nn.Module) -> frozenset:
    """The submodules whose ``weight`` Flax names ``scale``: LayerNorms."""
    return frozenset(n for n, m in module.named_modules() if isinstance(m, nn.LayerNorm))


def _flax_key(name: str, scale_owners: frozenset = frozenset()) -> str:
    if "." not in name:
        return name  # a parameter of the module itself (ViT's cls_token, pos_embed)
    owner, kind = name.rsplit(".", 1)
    if kind == "weight":
        kind = "scale" if owner in scale_owners else "kernel"
    return f"{owner}.{kind}"


def from_jax_params(module: nn.Module, flax_params: Mapping, mode: str = "strict") -> nn.Module:
    """Copy a Flax parameter tree into ``module`` in place and return it.
    Every value that is copied must have its parameter's shape. ``strict``
    raises unless every port parameter gets a value and every Flax leaf is
    used; ``subset`` allows unused leaves; ``overlay`` allows both, and a
    parameter without a leaf keeps its value."""
    if mode not in FROM_JAX_MODES:
        raise ValueError(f"mode {mode!r}; have {FROM_JAX_MODES}")
    tree = flax_params["params"] if "params" in flax_params else flax_params
    leaves = _flatten_leaves(tree)
    flatten_fed = getattr(module, "flatten_fed", {})
    scale_owners = _scale_owners(module)
    used = set()
    with torch.no_grad():
        for name, p in module.named_parameters():
            key = _flax_key(name, scale_owners)
            if key not in leaves:
                if mode == "overlay":
                    continue
                raise KeyError(f"no Flax parameter {key!r} for port parameter {name!r}")
            w = _to_port_layout(name, leaves[key], flatten_fed)
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"{name}: Flax {key} gives shape {w.shape}, "
                                 f"the port expects {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(w, dtype=np.float32)))
            used.add(key)
    unused = sorted(set(leaves) - used)
    if unused and mode == "strict":
        raise KeyError(f"Flax parameters with no port counterpart: {unused}")
    return module


def _to_jax_layout(name: str, w: np.ndarray, flatten_fed: Mapping[str, tuple]) -> np.ndarray:
    """The inverse of :func:`_to_port_layout`."""
    if w.ndim == 5:
        return np.transpose(w, (2, 3, 4, 1, 0))
    if w.ndim == 4:
        return np.transpose(w, (2, 3, 1, 0))
    if w.ndim == 2:
        owner = name.rsplit(".", 1)[0]
        if owner in flatten_fed:
            c, h, ww = flatten_fed[owner]
            o = w.shape[0]
            return w.reshape(o, c, h, ww).transpose(0, 2, 3, 1).reshape(o, h * ww * c).T
        return w.T
    return w


def to_jax_params(module: nn.Module) -> dict:
    """The Flax parameter tree of ``module`` (without the ``"params"``
    wrapper), float32 numpy leaves in Flax's layouts: what
    :func:`from_jax_params` reads back into the same module."""
    flatten_fed = getattr(module, "flatten_fed", {})
    scale_owners = _scale_owners(module)
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = _flax_key(name, scale_owners).split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        w = p.detach().cpu().float().numpy().astype(np.float32)
        node[leaf] = np.ascontiguousarray(_to_jax_layout(name, w, flatten_fed))
    return _sorted(tree)


def _sorted(tree: dict) -> dict:
    """Keys in sorted order at every level, as a JAX pytree keeps them."""
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def missing_modules(module: nn.Module, flax_params: Mapping) -> list[str]:
    """The top-level submodules of ``module`` with parameters that the tree
    has no entry for: what an ``overlay`` load leaves at their init (the
    JAX package's ``video_zoo._overlay`` reports the same names)."""
    tree = flax_params["params"] if "params" in flax_params else flax_params
    tops = {name.split(".", 1)[0] for name, _ in module.named_parameters()}
    return sorted(tops - set(tree))


def checkpoint_path(name: str, ckpt_dir: Optional[str] = None) -> str:
    """``{ckpt_dir or $I2V_TPU_CKPTS or ./checkpoints}/{name}.msgpack``."""
    ckpt_dir = ckpt_dir or os.environ.get("I2V_TPU_CKPTS", "./checkpoints")
    return os.path.join(ckpt_dir, f"{name}.msgpack")


def convert_swin3d(sd: Mapping) -> dict:
    """The published Video Swin checkpoint's state dict (mmaction's layout,
    optionally under ``"state_dict"``) → the port's :mod:`.swin3d` names:
    ``backbone.{patch_embed,layers.{i}.blocks.{j}.{norm1,attn.qkv,attn.proj,
    attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2},
    layers.{i}.downsample.{norm,reduction},norm}.*`` lose ``backbone.``,
    ``cls_head.fc_cls.*`` becomes ``fc.*``, and each
    ``relative_position_index`` is dropped (the port computes it). Values
    come back as float32 tensors."""
    sd = sd.get("state_dict", sd)
    out = {}
    for key, value in sd.items():
        if key.endswith("relative_position_index"):
            continue
        if key.startswith("backbone."):
            name = key[len("backbone."):]
        elif key.startswith("cls_head.fc_cls."):
            name = "fc." + key[len("cls_head.fc_cls."):]
        else:
            raise KeyError(f"{key!r} is not a key of a Video Swin checkpoint")
        out[name] = torch.as_tensor(value).float()
    return out


# the top-level names of PySlowFast's MViT keys that the port's module has
MVIT_KEYS = ("patch_embed.", "cls_token", "blocks.", "norm.", "head.projection.")


def convert_mvit(sd: Mapping) -> dict:
    """PySlowFast's MViTv2 checkpoint (its ``model_state``, optionally with
    the ``module.`` prefix of a data-parallel save) → the port's :mod:`.mvit`
    names, which are PySlowFast's: ``patch_embed.proj``, ``cls_token``,
    ``blocks.{i}.{norm1,norm2,proj,mlp.fc1,mlp.fc2,attn.{qkv,proj,pool_q,
    norm_q,pool_k,norm_k,pool_v,norm_v,rel_pos_h,rel_pos_w,rel_pos_t}}``,
    ``norm`` and ``head.projection``. Values come back as float32 tensors;
    a key of another model raises."""
    sd = sd.get("model_state", sd)
    out = {}
    for key, value in sd.items():
        name = key[len("module."):] if key.startswith("module.") else key
        if not name.startswith(MVIT_KEYS):
            raise KeyError(f"{key!r} is not a key of an MViTv2 checkpoint")
        out[name] = torch.as_tensor(value).float()
    return out


# the top-level names of Sense-X's UniFormer keys that the port's module has
UNIFORMER_KEYS = tuple(f"{k}{s}." for k in ("patch_embed", "blocks") for s in range(1, 5)) + (
    "norm.", "head.")
BN_STATS = ("running_mean", "running_var")


def convert_uniformer(sd: Mapping) -> dict:
    """Sense-X's UniFormer checkpoint (a state dict, or its training code's
    save with the state dict under ``model_state``, optionally with the
    ``module.`` prefix of a data-parallel save) → the port's
    :mod:`.uniformer` names, which are Sense-X's:
    ``patch_embed{1..4}.{proj,norm}``, ``blocks{1,2}.{i}.{pos_embed,norm1,
    conv1,attn,conv2,norm2,mlp.fc1,mlp.fc2}``, ``blocks{3,4}.{i}.{pos_embed,
    norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``, ``norm`` and
    ``head``. Each eval-mode BatchNorm3d (a module with running statistics)
    becomes its affine, ``weight`` γ/√(σ²+ε) and ``bias`` β − μ·γ/√(σ²+ε)
    (which the model folds into the linear after it); each 1×1×1 conv
    weight (O, I, 1, 1, 1) becomes the linear's (O, I). Values come back as
    float32 tensors; a key of another model raises."""
    sd = sd.get("model_state", sd)
    out, stats = {}, {}
    for key, value in sd.items():
        name = key[len("module."):] if key.startswith("module.") else key
        if not name.startswith(UNIFORMER_KEYS):
            raise KeyError(f"{key!r} is not a key of a UniFormer checkpoint")
        value = torch.as_tensor(value)
        prefix, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        if leaf in BN_STATS:
            stats.setdefault(prefix, {})[leaf] = value.double()
            continue
        value = value.float()
        if value.dim() == 5 and tuple(value.shape[2:]) == (1, 1, 1):
            value = value.reshape(value.shape[:2])
        out[name] = value
    for prefix, s in stats.items():
        gamma, beta = out[f"{prefix}.weight"].double(), out[f"{prefix}.bias"].double()
        scale = gamma / torch.sqrt(s["running_var"] + UNIFORMER_B["batch_norm_eps"])
        out[f"{prefix}.weight"] = scale.float()
        out[f"{prefix}.bias"] = (beta - s["running_mean"] * scale).float()
    return out


def save_params(params: dict, name: str, ckpt_dir: Optional[str] = None) -> str:
    """Write ``{"params": params}`` to :func:`checkpoint_path` in Flax's
    msgpack format (the JAX package's ``convert.save_params``)."""
    path = checkpoint_path(name, ckpt_dir)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(checkpoint.serialize({"params": params}))
    os.replace(tmp, path)
    return path


def load_params(name: str, ckpt_dir: Optional[str] = None) -> dict:
    """The parameter tree of :func:`checkpoint_path` (the ``"params"``
    wrapper taken off, where the file has one)."""
    with open(checkpoint_path(name, ckpt_dir), "rb") as f:
        tree = checkpoint.restore(f.read())
    return tree["params"] if "params" in tree else tree


def modifier_from_jax(mod_nhwc) -> torch.Tensor:
    """The JAX runner's (N, H, W, 3) modifier → the port's (N, 3, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(mod_nhwc), (0, 3, 1, 2))))


def modifier_to_jax(mod_nchw: torch.Tensor) -> np.ndarray:
    """The port's (N, 3, H, W) modifier → the JAX runner's (N, H, W, 3), in
    float32 (a bfloat16 moment's values, exactly)."""
    return np.ascontiguousarray(mod_nchw.detach().cpu().float().numpy().transpose(0, 2, 3, 1))


def adam_state_from_jax(count, mu, nu) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """optax's ``(count, mu, nu)`` → torch Adam's ``(step, exp_avg,
    exp_avg_sq)``: the count as a float32 scalar (exact below 2**24), the
    moments in the modifier's layout."""
    return (torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            modifier_from_jax(mu), modifier_from_jax(nu))


def adam_state_to_jax(step, exp_avg: torch.Tensor,
                      exp_avg_sq: torch.Tensor) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """torch Adam's ``(step, exp_avg, exp_avg_sq)`` → optax's ``(count int32,
    mu, nu)``."""
    return (np.asarray(int(torch.as_tensor(step)), dtype=np.int32),
            modifier_to_jax(exp_avg), modifier_to_jax(exp_avg_sq))
