"""White-box sign attacks against video recognition models.

PyTorch counterpart of :mod:`i2v_tpu.attacks.whitebox` (class names keep
the reference's spelling, so that the CLI dispatches by name):

  FGSM / BIM / MIFGSM           base_attacks.py:236-340
  SGM                           base_attacks.py:481-551
  SIM                           base_attacks.py:553-610

Each is the engine :func:`.core.run_sign_attack` with its own gradient
function, normalization and momentum. DIFGSM, TIFGSM, TIFGSM3D, TAP and
TemporalTranslation are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.api import VideoModel
from ..ops import pixel
from .core import Attack, SignAttackConfig, ce_value_and_grad, make_ce_grad_fn, run_sign_attack

EPS_DEFAULT = 16 / 255


class _SignEngineAttack(Attack):
    """Shared machinery: build the gradient function for the current attack
    mode and run the engine."""

    def __init__(self, name: str, model: VideoModel, cfg: SignAttackConfig):
        super().__init__(name, model, device=model.device)
        self.cfg = cfg
        self.epsilon = cfg.epsilon
        self.steps = cfg.steps
        self.step_size = cfg.alpha
        self._calls = 0

    def _build_grad_fn(self, bundle):
        return make_ce_grad_fn(bundle.apply_norm, self._targeted)

    def _attack01(self, clean01, labels):
        # fresh but reproducible randomness for each call, as the JAX engine
        # folds its call count into the key; FGSM/BIM/MI draw none of it
        generator = torch.Generator(device=clean01.device).manual_seed(self._calls)
        self._calls += 1
        return run_sign_attack(self._build_grad_fn(self.model), clean01, labels, self.cfg,
                               generator=generator)


class FGSM(_SignEngineAttack):
    """One-step sign attack: adv = clean + ε·sign(∇CE), clipped to [0,1]
    (reference: base_attacks.py:236-259)."""

    def __init__(self, model: VideoModel, steps=None, epsilon=EPS_DEFAULT):
        del steps  # the reference accepts and ignores it too
        super().__init__("FGSM", model, SignAttackConfig(epsilon=epsilon, steps=1,
                                                         step_size=epsilon))


class BIM(_SignEngineAttack):
    """Iterative FGSM with an ε-projection each step, step_size = ε/steps
    (reference: base_attacks.py:261-295)."""

    def __init__(self, model: VideoModel, epsilon=EPS_DEFAULT, steps=10):
        super().__init__("BIM", model, SignAttackConfig(epsilon=epsilon, steps=steps))


class MIFGSM(_SignEngineAttack):
    """Momentum iterative FGSM with frame-level L1-mean gradient
    normalization (reference: base_attacks.py:297-340)."""

    def __init__(self, model: VideoModel, epsilon=EPS_DEFAULT, steps=10, decay=1.0):
        super().__init__("MIFGSM", model, SignAttackConfig(
            epsilon=epsilon, steps=steps, use_momentum=True, decay=decay, grad_norm="frame"))


class SGM(_SignEngineAttack):
    """Skip Gradient Method: every non-stem ReLU gradient scaled by γ^0.5
    (reference: base_attacks.py:481-551), through the bundle's
    ``with_relu_grad_scale``."""

    def __init__(self, model: VideoModel, epsilon=EPS_DEFAULT, steps=10, decay=1.0,
                 gamma=0.5, momentum=False):
        super().__init__("SGM", model.with_relu_grad_scale(float(np.power(gamma, 0.5))),
                         SignAttackConfig(epsilon=epsilon, steps=steps, use_momentum=momentum,
                                          decay=decay, grad_norm="l1" if momentum else None))
        self.gamma = gamma


class SIM(_SignEngineAttack):
    """Scale-invariant method: gradients averaged over inputs scaled by
    1/2^i, i < scale_steps (reference: base_attacks.py:553-610).

    As the reference does, each gradient is taken w.r.t. the *scaled*
    normalized tensor, with no 1/2^i chain factor back to the input.
    ``batch_scales`` folds the scale copies into the batch: one forward and
    backward of n·B clips instead of n of B clips, the same mean-CE gradient,
    n times the activation memory."""

    def __init__(self, model: VideoModel, epsilon=EPS_DEFAULT, steps=10, decay=1.0,
                 scale_steps=5, momentum=False, batch_scales=False):
        super().__init__("SIM", model, SignAttackConfig(
            epsilon=epsilon, steps=steps, use_momentum=momentum, decay=decay,
            grad_norm="l1" if momentum else None))
        self.scale_steps = scale_steps
        self.batch_scales = batch_scales

    def _build_grad_fn(self, bundle):
        cost_and_grad = ce_value_and_grad(bundle.apply_norm, self._targeted)
        n = self.scale_steps
        if self.batch_scales:
            def grad_fn(adv01, labels, generator):
                x_norm = pixel.normalize(adv01, channel_axis=1)
                stacked = torch.cat([x_norm / (2.0**i) for i in range(n)])
                cost, gs = cost_and_grad(stacked, labels.repeat(n))
                return cost, gs.reshape((n,) + tuple(x_norm.shape)).sum(0)

            return grad_fn

        def grad_fn(adv01, labels, generator):
            x_norm = pixel.normalize(adv01, channel_axis=1)
            cost, gsum = 0.0, torch.zeros_like(x_norm)
            for i in range(n):
                c, g = cost_and_grad(x_norm * (1.0 / 2.0**i), labels)
                cost, gsum = cost + c, gsum + g
            return cost / n, gsum / n

        return grad_fn
