"""TemporalTranslation: the video-domain transfer attack.

PyTorch counterpart of :mod:`i2v_tpu.attacks.temporal` (reference:
video_attacks.py:14-230). Each step it (1) builds ``kernlen`` temporally
cycle-shifted variants of the clip, (2) takes the CE gradient of each,
(3) smooths the stack of variant gradients with a 1-D kernel, both as they
are ('same position') and rolled back by each variant's move ('different
position'), (4) mixes the two (1−w)·s + w·d, (5) applies optional momentum,
and (6) takes the sign step through the engine.

A chunk of variants is one forward and backward of chunk·B clips, the
variants side by side on the batch axis; the loss is the sum of each
variant's mean CE, so that each variant's gradient is that of its own mean
CE. The two smoothed sums are accumulated variant by variant, so no stack
of D gradients is held. Variants are ``torch.roll`` copies and the sums
elementwise: exact, and float32 in every precision mode.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.api import VideoModel
from ..ops import pixel, smoothing
from .core import Attack, SignAttackConfig, run_sign_attack_pieces


class TemporalTranslation(Attack):
    """params: kernlen (default 15), momentum (bool), weight (w of the
    rolled-back gradients), move_type ('adj' | 'large' | 'random'),
    kernel_mode ('gaussian' | 'linear' | 'uniform', alias 'random'), chunk
    (variants a gradient query; the reference sub-batches by 5,
    video_attacks.py:203-207). ``delay`` is the momentum decay."""

    def __init__(self, model: VideoModel, params: dict | None = None,
                 epsilon=16 / 255, steps=10, delay=1.0):
        super().__init__("TemporalTranslation", model, device=model.device)
        p = dict(kernlen=15, momentum=False, weight=0.0, move_type="adj",
                 kernel_mode="gaussian", chunk=5)
        p.update(params or {})
        self.epsilon = epsilon
        self.steps = steps
        self.step_size = epsilon / steps
        self.delay = delay
        self.kernlen = int(p["kernlen"])
        self.momentum = bool(p["momentum"])
        self.weight = float(p["weight"])
        self.move_type = str(p["move_type"])
        self.kernel_mode = str(p["kernel_mode"])
        self.chunk = int(p["chunk"])
        max_move = (self.kernlen - 1) // 2
        self.moves = tuple(range(-max_move, max_move + 1))
        self._kernel = smoothing.temporal_kernel(self.kernlen, self.kernel_mode)

    def _chunk_size(self) -> int:
        """The chunk, snapped down to a divisor of the variant count."""
        d = len(self.moves)
        chunk = max(1, min(self.chunk, d))
        while d % chunk:
            chunk -= 1
        return chunk

    def _shifts(self, frames: int, generator: torch.Generator) -> list[int]:
        """The shift applied to each variant this step."""
        if self.move_type == "adj":
            return list(self.moves)
        if self.move_type == "large":
            return [smoothing.large_move_shift(m, frames) for m in self.moves]
        # 'random' (video_attacks.py:124-140): randint(0, 101) % T with the
        # move's sign; move 0 stays 0
        rand = (torch.randint(0, 101, (len(self.moves),), generator=generator) % frames).tolist()
        return [0 if m == 0 else int(np.sign(m)) * r for m, r in zip(self.moves, rand)]

    def _build_grad_fn(self, model: VideoModel | None = None):
        model, targeted = model or self.model, self._targeted
        weight, moves, chunk = self.weight, self.moves, self._chunk_size()
        kernel = [float(k) for k in self._kernel]

        def grad_fn(adv01, labels, generator):
            b, frames = adv01.shape[0], adv01.shape[2]
            shifts = self._shifts(frames, generator)
            x_norm = pixel.normalize(adv01, channel_axis=1)
            s_grad = d_grad = None
            costs = []
            for c0 in range(0, len(moves), chunk):
                sh = shifts[c0:c0 + chunk]
                variants = torch.cat([smoothing.cycle_move(x_norm, s) for s in sh])
                variants.requires_grad_(True)
                with torch.enable_grad():
                    nll = F.cross_entropy(model.apply_norm(variants).float(),
                                          labels.repeat(len(sh)), reduction="none")
                    per_variant = targeted * nll.view(len(sh), b).mean(1)
                (g,) = torch.autograd.grad(per_variant.sum(), variants)
                costs.append(per_variant.detach())
                for j, gi in enumerate(g.reshape((len(sh), b) + g.shape[1:])):
                    k, move = kernel[c0 + j], moves[c0 + j]
                    # rolled back by the NOMINAL move even where 'large' or
                    # 'random' applied another shift (video_attacks.py:169-170)
                    back = torch.roll(gi, -move, dims=2)
                    if s_grad is None:
                        s_grad, d_grad = gi * k, back * k
                    else:
                        s_grad.add_(gi, alpha=k)
                        d_grad.add_(back, alpha=k)
            # the step's cost: the mean of the variants' costs
            return torch.cat(costs).mean(), (1.0 - weight) * s_grad + weight * d_grad

        return grad_fn

    def _attack_pieces(self, clean_pieces, label_pieces, devices):
        cfg = SignAttackConfig(epsilon=self.epsilon, steps=self.steps, step_size=self.step_size,
                               use_momentum=self.momentum, decay=self.delay,
                               grad_norm="frame" if self.momentum else None)
        return run_sign_attack_pieces([self._build_grad_fn(self._replica(d)) for d in devices],
                                      clean_pieces, label_pieces, cfg,
                                      generator=self._next_generator())
