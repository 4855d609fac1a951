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
  ``i2v_tpu.models.convert.dense_kernel_from_flatten``).
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

``fold_bn`` folds a BatchNorm into the preceding conv, as the JAX package's
converter does, so that a torchvision state_dict can feed the port later.

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

BN_EPS = 1e-5
FROM_JAX_MODES = ("strict", "subset", "overlay")


def fold_bn(conv_w: np.ndarray, conv_b: Optional[np.ndarray], bn: Mapping,
            prefix: str) -> tuple[np.ndarray, np.ndarray]:
    """Fold a BN layer (torch names ``{prefix}.weight/bias/running_mean/
    running_var``) into the preceding conv's (O, ...) weight + bias:
    W' = W·γ/√(σ²+ε) per out-channel, b' = β − μ·γ/√(σ²+ε) + b·γ/√(σ²+ε)."""
    def arr(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)

    gamma = arr(bn[f"{prefix}.weight"])
    beta = arr(bn[f"{prefix}.bias"])
    mean = arr(bn[f"{prefix}.running_mean"])
    var = arr(bn[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    shape = (-1,) + (1,) * (conv_w.ndim - 1)
    w = conv_w * scale.reshape(shape)
    b = beta - mean * scale
    if conv_b is not None:
        b = b + conv_b * scale
    return w, b


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
