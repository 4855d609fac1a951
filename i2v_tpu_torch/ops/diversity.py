"""DI-FGSM's input diversity as an index selection.

PyTorch counterpart of :mod:`i2v_tpu.ops.diversity`. The reference resizes
frames to a random size in [224, 250), pads them at random to 250 and
resizes back to 224, with probability 0.5 (base_attacks.py:356-376). The
whole resize → pad → resize chain is one source index a row and a column
(nearest neighbour both ways) or padding, so it is two ``index_select``
calls and a mask: exact in every precision mode, where the JAX package's
one-hot matmuls (its TPU form) would run in TF32 on the card.

The draws come from a ``torch.Generator`` on the CPU, as Python numbers:
the indices are built from them without reading anything back from the
card. They cannot equal the JAX package's ``jax.random`` draws; the two are
compared at pinned draws through :func:`diversity_gather`.

The attack draws a whole call's rows at once (:func:`draw_table`, the same
draws in the same order as :func:`draw` a step), and each step reads its
row on the device (:func:`diversity_gather_row`): the indices are then
device integer arithmetic on the row, and a kept row gathers by the
identity, so that the step is one fixed-shape ``index_select`` pair with no
host decision, which a CUDA graph can hold (the JAX package's draws are
traced values inside its jit, ``i2v_tpu/ops/diversity.py:36-44``).
"""

from __future__ import annotations

import numpy as np
import torch


def default_range(size: int) -> tuple[int, int]:
    """(low, high) of the resize: low = the input size, high =
    round(size·250/224), the reference's 224 → [224, 250) margin at any size."""
    return size, max(size + 2, round(size * 250 / 224))


def draw(generator: torch.Generator, low: int, high: int, keep_prob: float = 0.5):
    """One step's draws → (apply, rnd, pad_top, pad_left): ``rnd`` uniform in
    [low, high); each pad ``floor(U·(high − rnd))``; the transform applies
    when ``U ≥ keep_prob`` (``keep_prob`` is the chance of the identity)."""
    rnd = int(torch.randint(low, high, (), generator=generator))
    u_top, u_left, u_apply = torch.rand(3, generator=generator, dtype=torch.float64).tolist()
    h_rem = high - rnd  # ≥ 1
    return u_apply >= keep_prob, rnd, int(u_top * h_rem), int(u_left * h_rem)


def draw_table(generator: torch.Generator, steps: int, low: int, high: int,
               keep_prob: float = 0.5) -> np.ndarray:
    """A call's draws: ``(steps, 4)`` int64 rows ``(apply, rnd, pad_top,
    pad_left)``, row t the :func:`draw` of step t from ``generator``."""
    return np.asarray([[int(a), rnd, top, left] for a, rnd, top, left in
                       (draw(generator, low, high, keep_prob) for _ in range(steps))],
                      dtype=np.int64).reshape(steps, 4)


def input_diversity(x: torch.Tensor, generator, keep_prob: float = 0.5,
                    low: int | None = None, high: int | None = None) -> torch.Tensor:
    """The DI transform of ``x`` (..., H, W), H = W = ``low``, with the
    step's draws: from ``generator`` (:func:`draw`), or, where ``generator``
    is a row of :func:`draw_table` as a device tensor, that row's
    (:func:`diversity_gather_row`; ``keep_prob`` was spent drawing it)."""
    d_low, d_high = default_range(x.shape[-1])
    low = d_low if low is None else low
    high = d_high if high is None else high
    if isinstance(generator, torch.Tensor):
        return diversity_gather_row(x, generator, low, high)
    apply, rnd, pad_top, pad_left = draw(generator, low, high, keep_prob)
    return diversity_gather(x, rnd, pad_top, pad_left, low, high) if apply else x


def _axis_index(rnd: int, pad: int, low: int, high: int, device):
    """Source index along one axis and whether it lies in the resized image
    (else the output is padding)."""
    out_idx = torch.arange(low, device=device)
    # final nearest resize high → low: position in the padded canvas
    in_resized = (out_idx * high) // low - pad
    valid = (in_resized >= 0) & (in_resized < rnd)
    # nearest resize low → rnd: source index in the original image
    src = torch.clamp((torch.clamp(in_resized, min=0) * low) // rnd, 0, low - 1)
    return src, valid


def diversity_gather(x: torch.Tensor, rnd: int, pad_top: int, pad_left: int, low: int,
                     high: int) -> torch.Tensor:
    """The resize(low → rnd, nearest) → pad(to high) → resize(high → low,
    nearest) chain for pinned draws, over the last two axes of ``x``."""
    src_r, valid_r = _axis_index(rnd, pad_top, low, high, x.device)
    src_c, valid_c = _axis_index(rnd, pad_left, low, high, x.device)
    y = x.index_select(-2, src_r).index_select(-1, src_c)
    return torch.where(valid_r[:, None] & valid_c[None, :], y, torch.zeros((), dtype=x.dtype,
                                                                        device=x.device))


def diversity_gather_row(x: torch.Tensor, row: torch.Tensor, low: int, high: int) -> torch.Tensor:
    """:func:`diversity_gather` at a :func:`draw_table` row held on the
    device, its indices built there: where the row applies the transform,
    the same indices and mask, so the same values; where it keeps the
    input, the identity indices and an all-true mask, so ``x``'s values (and
    the gradient ``g + 0``). Nothing is read back to the host."""
    apply, rnd = row[0] != 0, row[1]
    out_idx = torch.arange(low, device=x.device)

    def axis(pad):
        in_resized = (out_idx * high) // low - pad
        valid = (in_resized >= 0) & (in_resized < rnd)
        src = torch.clamp((torch.clamp(in_resized, min=0) * low) // rnd, 0, low - 1)
        return torch.where(apply, src, out_idx), valid | ~apply

    src_r, valid_r = axis(row[2])
    src_c, valid_c = axis(row[3])
    y = x.index_select(-2, src_r).index_select(-1, src_c)
    return torch.where(valid_r[:, None] & valid_c[None, :], y, torch.zeros((), dtype=x.dtype,
                                                                        device=x.device))
