"""Attack loss functions: the per-frame cosine objective of I2V / ENS-I2V /
AENS-I2V-MF, DR's activation dispersion, ILAF's feature-displacement gain,
TAP's signed-√ feature distance, and the cross-entropy of the white-box
attacks.

PyTorch counterpart of :mod:`i2v_tpu.ops.losses` (reference:
image_attacks.py:216-220, 336-347, 597-613, base_attacks.py:784-792,
TPAMI_attack.py:271-287). Taps arrive as explicit model outputs, first
axis = frames (or clips, for ILAF's video taps).
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


def dispersion_cost(taps: Sequence[torch.Tensor]) -> torch.Tensor:
    """DR's objective, minimized: Σ over taps of the unbiased (ddof=1) std of
    all the tap's elements, as torch's ``.std()`` (reference:
    image_attacks.py:216-220)."""
    total = 0.0
    for t in taps:
        total = total + torch.std(t.float(), correction=1)
    return total


def tap_feature_distance(taps_adv: Sequence[torch.Tensor], taps_clean: Sequence[torch.Tensor],
                         batch: int) -> torch.Tensor:
    """TAP's mid-layer distance: a per-sample L2 between ``signed_sqrt`` maps,
    summed over taps → (batch,) (reference: base_attacks.py:789-792). The
    1e-12 inside the sqrt keeps the norm's gradient finite at adv == clean."""
    from .activations import signed_sqrt

    per_tap = []
    for a, c in zip(taps_adv, taps_clean):
        d = signed_sqrt(a.float()).reshape(batch, -1) - signed_sqrt(c.float()).reshape(batch, -1)
        per_tap.append(torch.sqrt(torch.sum(d * d, dim=1) + 1e-12))
    return torch.sum(torch.stack(per_tap), dim=0)


def ilaf_cost(taps_step: Sequence[torch.Tensor], taps_clean: Sequence[torch.Tensor],
              init_directions: Sequence[torch.Tensor],
              init_norms: Sequence[torch.Tensor]) -> torch.Tensor:
    """ILAF's objective, minimized: −Σ over taps of
    (0.5·‖Δ_step‖/‖Δ_init‖ + ⟨dir_init, dir_step⟩), Δ = feat − feat(clean)
    (reference: image_attacks.py:597-613)."""
    total = 0.0
    for step_t, clean_t, init_dir, init_norm in zip(taps_step, taps_clean, init_directions,
                                                    init_norms):
        delta = (step_t - clean_t).float()
        # the 1e-24 inside the sqrt keeps ∂‖δ‖/∂δ finite at δ = 0 (adv == clean)
        step_norm = torch.sqrt(torch.sum(delta * delta) + 1e-24)
        step_dir = delta / step_norm
        magnitude_gain = step_norm / (init_norm + 1e-12)
        angle = torch.sum(init_dir.float() * step_dir)
        total = total - (0.5 * magnitude_gain + angle)
    return total


def feature_delta_direction(taps_adv: Sequence[torch.Tensor],
                            taps_clean: Sequence[torch.Tensor]):
    """ILAF's starting directions and norms: (feat(adv) − feat(clean)) over
    its L2 norm, and that norm, per tap (reference: image_attacks.py:561-567).
    Returns (directions, norms)."""
    dirs, norms = [], []
    for a, c in zip(taps_adv, taps_clean):
        d = (a - c).float()
        n = torch.linalg.vector_norm(d)
        dirs.append(d / (n + 1e-12))  # 0/0 guard when adv == clean
        norms.append(n)
    return dirs, norms
