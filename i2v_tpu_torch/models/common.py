"""Shared building blocks for the image backbones.

PyTorch counterpart of :mod:`i2v_tpu.models.common`:
  - NCHW layout; models take **[0,1]-domain** inputs and apply ImageNet
    normalization as their first op.
  - Feature taps are explicit return values keyed by depth (the reference
    reads them through forward hooks, image_attacks.py:273-292).
  - ``truncate=True`` builds and runs nothing past the deepest requested
    tap: no parameters, no compute (image_attacks.py:318,334 runs the full
    network and hooks the middle; the taps are identical).
  - BatchNorm is folded into the preceding conv (:func:`.convert.fold_bn`),
    so the convs carry a bias and there is no BN module (DenseNet, which is
    pre-activation, keeps a frozen affine instead). On a card, ResNet's,
    VGG-16's, AlexNet's and SqueezeNet's convs, and the 3-D convs of I3D,
    SlowFast and TPN, run without their bias, and the bias, residual and
    ReLU after each come in one in-place pass (:func:`conv_act`).
  - Every image module's forward takes ``tap_offset`` ({tap: tensor}),
    added to the tap activation in-flow (Grad-CAM's exact ∂/∂tap).
  - Every image and video module takes a compute ``dtype`` (float32 by
    default), in the JAX modules' order: ImageNet normalization runs in
    float32 on the [0,1] input and the cast to ``dtype`` comes after it;
    convs and linears compute in ``dtype`` on weights cast to it (Flax's
    ``nn.Conv(dtype=...)``, whose output is ``dtype``); the logits come back
    as float32. The conv and linear weights are held in ``dtype`` (Flax casts
    its float32 parameters at every call; the values are the same), while
    norms and embeddings keep float32 and are cast where they are used, as
    the JAX modules cast them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import kernels
from ..ops.activations import grad_scaled_relu


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its weight's dtype: the input is cast
    to it first, as Flax's ``nn.Conv(dtype=...)`` promotes its input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return self._conv_forward(x.to(w.dtype), w, self.bias)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` that computes in its weight's dtype (see :class:`Conv2d`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return self._conv_forward(x.to(w.dtype), w, self.bias)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its weight's dtype, as Flax's
    ``nn.Dense(dtype=...)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return F.linear(x.to(w.dtype), w, self.bias)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype = torch.float32) -> nn.Module:
    """Cast the weights and biases of every conv and linear layer of
    ``module`` to ``dtype``, record ``dtype`` as its compute dtype
    (``module.dtype``) and return it. Norms and embeddings keep their
    dtype. Casting float32 weights rounds them once, to the values Flax's
    modules compute with; a float32 model cast to bfloat16 and one built
    and loaded in bfloat16 hold the same weights."""
    if not dtype.is_floating_point:
        raise ValueError(f"a compute dtype must be floating, got {dtype}")
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            m.to(dtype)
    module.dtype = dtype
    return module


def check_dtype_on_device(dtype: torch.dtype, device) -> None:
    """Raise where ``device`` cannot compute in ``dtype``: a bfloat16 model
    on a CUDA card without bfloat16 support is refused, not run in float32."""
    device = torch.device(device)
    if (dtype == torch.bfloat16 and device.type == "cuda"
            and not torch.cuda.is_bf16_supported()):
        raise RuntimeError(f"{torch.cuda.get_device_name(device)} does not compute in "
                           "bfloat16; build the model in float32")


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    """2-D conv with symmetric integer padding and bias."""
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=True)


def _on_card(x: torch.Tensor) -> bool:
    # a function of its own, so that a CPU test can take the card's path
    return x.is_cuda


def conv_act(conv: nn.Conv2d | nn.Conv3d, x: torch.Tensor, residual: torch.Tensor | None = None,
             relu: bool = True, relu_grad_scale: float = 1.0) -> torch.Tensor:
    """``act(conv(x) (+ residual))``, act ReLU or the identity, the ReLU's
    backward scaled by ``relu_grad_scale`` (SGM) unless it is 1. On a card
    the conv runs without its bias and
    :func:`~i2v_tpu_torch.ops.kernels.bias_act` adds the bias and the
    residual and applies the ReLU in one pass, in place on the conv's
    output: the same bits as the ops below, which run everywhere else (the
    CPU, the meta device) as they are written."""
    if _on_card(x):
        w = conv.weight
        return kernels.bias_act(conv._conv_forward(x.to(w.dtype), w, None), conv.bias,
                                residual, relu, relu_grad_scale)
    y = conv(x)
    if residual is not None:
        y = y + residual
    if not relu:
        return y
    return F.relu(y) if relu_grad_scale == 1.0 else grad_scaled_relu(y, relu_grad_scale)


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    """torch max pool. With ``ceil_mode`` the last partial window is kept;
    for every window shape used here (kernel ≥ stride) that is the JAX
    package's extra right/bottom −inf padding (tests pin the sizes)."""
    return F.max_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode)


def add_offset(x: torch.Tensor, tap_offset, depth: int) -> torch.Tensor:
    """``x + tap_offset[depth]`` where the caller passed one (Grad-CAM's
    in-flow offset, differentiated at 0), else ``x`` itself."""
    if tap_offset is not None and depth in tap_offset:
        return x + tap_offset[depth]
    return x


def collect_tap(taps: dict, want: Sequence[int], depth: int, value) -> None:
    if depth in want:
        taps[depth] = value


def deepest(want: Sequence[int], truncate: bool, everything: int) -> int:
    """The last depth a module builds and runs: the deepest requested tap
    when truncating, else ``everything``."""
    return max(want) if (truncate and want) else everything
