"""Gradient normalization helpers (reference: utils.py:58-67).

PyTorch counterpart of :mod:`i2v_tpu.ops.grads`. Gradients are clip
gradients ``(B, C, T, H, W)``. An identically-zero slice normalizes to zero
(0/0 would give NaN and poison the momentum carry); a NaN gradient stays
NaN, so that a fault surfaces instead of being zeroed.
"""

from __future__ import annotations

import torch


def _divide_unless_zero(grads: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    # keyed on norm == 0 (not > 0) so that a NaN norm still propagates
    zero = norm == 0
    return torch.where(zero, torch.zeros_like(grads),
                       grads / torch.where(zero, torch.ones_like(norm), norm))


def norm_grads(grads: torch.Tensor, frame_level: bool = True) -> torch.Tensor:
    """L1-mean normalization: each frame by mean |g| over (C, H, W) with
    ``frame_level``, else each clip by mean |g| over (C, T, H, W)."""
    if grads.ndim != 5:
        raise ValueError(f"expected (B,C,T,H,W) clip gradient, got shape {tuple(grads.shape)}")
    dims = (1, 3, 4) if frame_level else (1, 2, 3, 4)
    return _divide_unless_zero(grads, torch.mean(torch.abs(grads), dim=dims, keepdim=True))


def l1_normalize(grads: torch.Tensor, total: torch.Tensor | None = None) -> torch.Tensor:
    """Whole-tensor L1 normalization (reference: base_attacks.py:398-399).
    ``total`` is the whole tensor's Σ|g| where ``grads`` is one piece of it."""
    if total is None:
        total = torch.sum(torch.abs(grads))
    return _divide_unless_zero(grads, total)
