"""Gradient-surgery activations.

PyTorch counterpart of :mod:`i2v_tpu.ops.activations`. SGM (Skip Gradient
Method) scales the gradient that flows back through every non-stem ReLU by
γ^0.5; the reference does it with backward hooks (base_attacks.py:495-511),
the JAX package with a custom-VJP ReLU, and the port with an
``autograd.Function``: the forward is ReLU, the backward ``g·scale·[x > 0]``.
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
