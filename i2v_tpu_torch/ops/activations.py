"""Gradient-surgery activations.

PyTorch counterpart of :mod:`i2v_tpu.ops.activations`. SGM (Skip Gradient
Method) scales the gradient that flows back through every non-stem ReLU by
γ^0.5; the reference does it with backward hooks (base_attacks.py:495-511),
the JAX package with a custom-VJP ReLU, and the port with an
``autograd.Function``: the forward is ReLU, the backward ``g·scale·[x > 0]``.
TAP's zero-safe signed square root is another ``autograd.Function``.
"""

from __future__ import annotations

import torch


class GradScaledReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ctx.scale * (x > 0).to(g.dtype), None


def grad_scaled_relu(x: torch.Tensor, scale: float) -> torch.Tensor:
    return GradScaledReLU.apply(x, scale)


class SignedSqrt(torch.autograd.Function):
    """``sign(x)·√|x|`` with the derivative ``1/(2√|x|)`` off 0 and exactly 0
    at 0. The plain composition's gradient is 0·∞ = NaN at 0, and TAP's ReLU
    taps are 0 on about half their units (reference: base_attacks.py:790)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sign(x) * torch.sqrt(torch.abs(x))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        denom = 2.0 * torch.sqrt(torch.abs(x))
        return torch.where(x == 0, torch.zeros_like(g),
                           g / torch.where(denom == 0, torch.ones_like(denom), denom))


def signed_sqrt(x: torch.Tensor) -> torch.Tensor:
    return SignedSqrt.apply(x)
