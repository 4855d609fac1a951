"""Attack loss functions: the per-frame cosine objective of I2V / ENS-I2V,
and the cross-entropy of the white-box attacks.

PyTorch counterpart of the cosine and cross-entropy parts of
:mod:`i2v_tpu.ops.losses` (reference: image_attacks.py:336-347,
TPAMI_attack.py:271-287). Taps arrive as explicit model outputs, first
axis = frames.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

# torch.nn.functional.cosine_similarity clamps each norm at eps=1e-8; written
# out here so the clamp is visible and matches the JAX package's.
_COS_EPS = 1e-8


def cosine_similarity_flat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between row-flattened features, one value per row,
    with each row's norm clamped at 1e-8."""
    n = a.shape[0]
    af = a.reshape(n, -1).float()
    bf = b.reshape(n, -1).float()
    dot = torch.sum(af * bf, dim=-1)
    na = torch.clamp(torch.linalg.vector_norm(af, dim=-1), min=_COS_EPS)
    nb = torch.clamp(torch.linalg.vector_norm(bf, dim=-1), min=_COS_EPS)
    return dot / (na * nb)


def i2v_cost(taps_adv: Sequence[torch.Tensor], taps_clean: Sequence[torch.Tensor],
             frame_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ over taps of per-frame cosine similarity, summed over frames.
    ``frame_weights`` (N,) masks frames out of the cost (a weight of 1.0
    multiplies exactly)."""
    total = 0.0
    for a, c in zip(taps_adv, taps_clean):
        cos = cosine_similarity_flat(a, c)
        if frame_weights is not None:
            cos = cos * frame_weights
        total = total + torch.sum(cos)
    return total


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, ``nn.CrossEntropyLoss()`` (the white-box
    attacks' objective)."""
    return F.cross_entropy(logits.float(), labels.long())


def per_tap_frame_cosines(taps_adv: Sequence[torch.Tensor],
                          taps_clean: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stacked per-tap per-frame cosine matrix (n_taps, N)."""
    return torch.stack([cosine_similarity_flat(a, c) for a, c in zip(taps_adv, taps_clean)])
