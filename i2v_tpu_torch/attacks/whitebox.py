"""White-box sign attacks against video recognition models.

PyTorch counterpart of :mod:`i2v_tpu.attacks.whitebox` (class names keep
the reference's spelling, so that the CLI dispatches by name):

  FGSM / BIM / MIFGSM           base_attacks.py:236-340
  DIFGSM                        base_attacks.py:342-411
  TIFGSM / TIFGSM3D             base_attacks.py:413-479, 612-683
  SGM                           base_attacks.py:481-551
  SIM                           base_attacks.py:553-610
  TAP                           base_attacks.py:685-814

Each is the engine :class:`.core.SignLoop` with its own gradient function,
smoothing, normalization and momentum, kept a batch layout: on a card each
step after the first replays a CUDA graph (``graphs=False`` runs them
eagerly). DIFGSM draws a call's transforms on the host before the loop, and
each step reads its row from a device table. TemporalTranslation is in
:mod:`.temporal`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.api import VideoModel
from ..ops import diversity, grads as grad_ops, losses, pixel, smoothing
from .core import (Attack, SignAttackConfig, SignLoop, ce_value_and_grad, loop_key,
                   make_ce_grad_fn)

EPS_DEFAULT = 16 / 255


class _SignEngineAttack(Attack):
    """Shared machinery: build the gradient function for the current attack
    mode and run the engine, one :class:`SignLoop` a batch layout."""

    def __init__(self, name: str, model: VideoModel, cfg: SignAttackConfig,
                 graphs: bool = True):
        super().__init__(name, model, device=model.device)
        self.cfg = cfg
        self.epsilon = cfg.epsilon
        self.steps = cfg.steps
        self.step_size = cfg.alpha
        self.graphs = graphs
        self._loops: dict = {}

    def _build_grad_fn(self, bundle):
        return make_ce_grad_fn(bundle.apply_norm, self._targeted)

    def _build_smooth_fn(self):
        return None

    def _draws(self, clean_pieces):
        """The loop's ``draws`` for this batch layout (None: no draws)."""
        return None

    def _attack_pieces(self, clean_pieces, label_pieces, devices):
        generator = self._next_generator()
        key = loop_key(clean_pieces, devices, self._targeted)
        if key not in self._loops:
            self._loops[key] = SignLoop(
                lambda clean: [self._build_grad_fn(self._replica(d)) for d in devices],
                clean_pieces, self.cfg, smooth_fn=self._build_smooth_fn(), graphs=self.graphs,
                draws=self._draws(clean_pieces))
        return self._loops[key].run(clean_pieces, label_pieces, generator)


class FGSM(_SignEngineAttack):
    """One-step sign attack: adv = clean + ε·sign(∇CE), clipped to [0,1]
    (reference: base_attacks.py:236-259)."""

    def __init__(self, model: VideoModel, steps=None, epsilon=EPS_DEFAULT, graphs: bool = True):
        del steps  # the reference accepts and ignores it too
        super().__init__("FGSM", model, SignAttackConfig(epsilon=epsilon, steps=1,
                                                         step_size=epsilon), graphs)


class BIM(_SignEngineAttack):
    """Iterative FGSM with an ε-projection each step, step_size = ε/steps
    (reference: base_attacks.py:261-295)."""

    def __init__(self, model: VideoModel, epsilon=EPS_DEFAULT, steps=10, graphs: bool = True):
        super().__init__("BIM", model, SignAttackConfig(epsilon=epsilon, steps=steps), graphs)


class MIFGSM(_SignEngineAttack):
    """Momentum iterative FGSM with frame-level L1-mean gradient
    normalization (reference: base_attacks.py:297-340)."""

    def __init__(self, model: VideoModel, epsilon=EPS_DEFAULT, steps=10, decay=1.0,
                 graphs: bool = True):
        super().__init__("MIFGSM", model, SignAttackConfig(
            epsilon=epsilon, steps=steps, use_momentum=True, decay=decay, grad_norm="frame"),
            graphs)


class DIFGSM(_SignEngineAttack):
    """Diverse-inputs FGSM: a random resize and pad of the normalized input
    with probability 0.5 each step (reference: base_attacks.py:342-411);
    optional momentum with whole-tensor L1 normalization. A call's draws
    come from its generator before the loop (:func:`.diversity.draw_table`),
    and each step reads its row on the device, the same row for every
    clip-batch chunk and every mesh piece."""

    def __init__(self, model: VideoModel, epsilon=EPS_DEFAULT, steps=10, decay=1.0,
                 momentum=False, graphs: bool = True):
        super().__init__("DIFGSM", model, SignAttackConfig(
            epsilon=epsilon, steps=steps, use_momentum=momentum, decay=decay,
            grad_norm="l1" if momentum else None), graphs)

    def _draws(self, clean_pieces):
        steps, (low, high) = self.cfg.steps, diversity.default_range(clean_pieces[0].shape[-1])
        return lambda generator: diversity.draw_table(generator, steps, low, high)

    def _build_grad_fn(self, bundle):
        targeted = self._targeted

        def grad_fn(adv01, labels, draws):
            x_norm = pixel.normalize(adv01, channel_axis=1).detach().requires_grad_(True)
            with torch.enable_grad():
                y = diversity.input_diversity(x_norm, draws)
                cost = targeted * losses.cross_entropy(bundle.apply_norm(y), labels)
            (g,) = torch.autograd.grad(cost, x_norm)
            return cost.detach(), g

        return grad_fn


class TIFGSM(_SignEngineAttack):
    """Translation-invariant FGSM: a 15×15 Gaussian depthwise smoothing of
    each frame's gradient (reference: base_attacks.py:413-479), as two 1-D
    passes of the Gaussian factor."""

    def __init__(self, model: VideoModel, epsilon=EPS_DEFAULT, steps=10, decay=1.0,
                 momentum=False, kernlen=15, nsig=3.0, graphs: bool = True):
        super().__init__("TIFGSM", model, SignAttackConfig(
            epsilon=epsilon, steps=steps, use_momentum=momentum, decay=decay), graphs)
        self._k1d = smoothing.gaussian_1d(kernlen, nsig)

    def _build_smooth_fn(self):
        k1d = self._k1d
        return lambda g: smoothing.ti_smooth_2d_separable(g, k1d)


class TIFGSM3D(_SignEngineAttack):
    """3-D translation-invariant FGSM: the separable 15³ Gaussian over
    (T, H, W), then frame-level normalization (reference:
    base_attacks.py:612-683)."""

    def __init__(self, model: VideoModel, epsilon=EPS_DEFAULT, steps=10, decay=1.0,
                 momentum=False, kernlen=15, nsig=3.0, graphs: bool = True):
        super().__init__("TIFGSM3D", model, SignAttackConfig(
            epsilon=epsilon, steps=steps, use_momentum=momentum, decay=decay), graphs)
        self._k1d = smoothing.gaussian_1d(kernlen, nsig)

    def _build_smooth_fn(self):
        k1d = self._k1d
        return lambda g: grad_ops.norm_grads(smoothing.depthwise_conv3d_separable(g, k1d), True)


class SGM(_SignEngineAttack):
    """Skip Gradient Method: every non-stem ReLU gradient scaled by γ^0.5
    (reference: base_attacks.py:481-551), through the bundle's
    ``with_relu_grad_scale``."""

    def __init__(self, model: VideoModel, epsilon=EPS_DEFAULT, steps=10, decay=1.0,
                 gamma=0.5, momentum=False, graphs: bool = True):
        super().__init__("SGM", model.with_relu_grad_scale(float(np.power(gamma, 0.5))),
                         SignAttackConfig(epsilon=epsilon, steps=steps, use_momentum=momentum,
                                          decay=decay, grad_norm="l1" if momentum else None),
                         graphs)
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
                 scale_steps=5, momentum=False, batch_scales=False, graphs: bool = True):
        super().__init__("SIM", model, SignAttackConfig(
            epsilon=epsilon, steps=steps, use_momentum=momentum, decay=decay,
            grad_norm="l1" if momentum else None), graphs)
        self.scale_steps = scale_steps
        self.batch_scales = batch_scales

    def _build_grad_fn(self, bundle):
        cost_and_grad = ce_value_and_grad(bundle.apply_norm, self._targeted)
        n = self.scale_steps
        if self.batch_scales:
            def grad_fn(adv01, labels, draws):
                x_norm = pixel.normalize(adv01, channel_axis=1)
                stacked = torch.cat([x_norm / (2.0**i) for i in range(n)])
                cost, gs = cost_and_grad(stacked, labels.repeat(n))
                return cost, gs.reshape((n,) + tuple(x_norm.shape)).sum(0)

            return grad_fn

        def grad_fn(adv01, labels, draws):
            x_norm = pixel.normalize(adv01, channel_axis=1)
            cost, gsum = 0.0, torch.zeros_like(x_norm)
            for i in range(n):
                c, g = cost_and_grad(x_norm * (1.0 / 2.0**i), labels)
                cost, gsum = cost + c, gsum + g
            return cost / n, gsum / n

        return grad_fn


class TAP(Attack):
    """Transferable Adversarial Perturbations: CE + η·Σ|smoothed perturbation|
    + feat_coef·Σ signed-√ feature distance over early video-model taps,
    ascended (reference: base_attacks.py:685-814).

    The bundle's ``tap_keys`` pick the layers (I3D res_layer1-2; SlowFast
    slow and fast res2-3; TPN layer1-2; base_attacks.py:737-743). The clean
    taps are computed once a call. The reference's per-sample distance is
    summed over the batch; η is 1e3 whatever the params say there
    (base_attacks.py:801), a parameter here. Costs are recorded as four
    numbers a step: total, CE, smoothness and distance."""

    def __init__(self, model: VideoModel, params: Optional[dict] = None,
                 epsilon=EPS_DEFAULT, steps=10, graphs: bool = True):
        super().__init__("TAP", model, device=model.device)
        self.graphs = graphs
        self._loops: dict = {}
        p = dict(kernlen=3, temporal_kernlen=3, eta=1e3, conv3d=True, feat_coef=0.05)
        p.update(params or {})
        self.epsilon = epsilon
        self.steps = steps
        self.step_size = epsilon / steps
        self.kernlen = int(p["kernlen"])
        self.temporal_kernlen = int(p["temporal_kernlen"])
        self.eta = float(p["eta"])
        self.conv3d = bool(p["conv3d"])
        self.feat_coef = float(p["feat_coef"])
        if self.conv3d:
            self._kernel = smoothing.uniform_kernel_3d(self.kernlen, self.temporal_kernlen)
        else:
            self._kernel = smoothing.uniform_kernel_2d(self.kernlen)

    def _build_grad_fn(self, clean01, model: Optional[VideoModel] = None,
                       ce_weight: float = 1.0):
        """The TAP cost and its gradient w.r.t. the normalized input, around
        the clean clip's taps, through ``model`` (default: the attack's).
        The smoothness and the distance are sums over clips and the CE a
        mean: a piece of a batch cut in k weighs its CE by ``ce_weight`` =
        1/k, so that the pieces' costs and gradients sum to the whole
        batch's. ``grad_fn.refresh()`` recomputes the clean taps in place
        after a new batch is copied into ``clean01``."""
        model, targeted = model or self.model, self._targeted
        smooth = smoothing.depthwise_conv3d if self.conv3d else smoothing.depthwise_conv2d_frames
        kernel, eta, feat_coef = self._kernel, self.eta, self.feat_coef
        x_clean = pixel.normalize(clean01, channel_axis=1)
        with torch.no_grad():
            _, clean_taps = model.apply_norm_taps(x_clean)
        batch = clean01.shape[0]

        def grad_fn(adv01, labels, draws):
            x_norm = pixel.normalize(adv01, channel_axis=1).detach().requires_grad_(True)
            with torch.enable_grad():
                logits, taps = model.apply_norm_taps(x_norm)
                ce = targeted * losses.cross_entropy(logits, labels)
                if ce_weight != 1.0:
                    ce = ce * ce_weight
                dist = torch.sum(losses.tap_feature_distance(taps, clean_taps, batch))
                # the perturbation at the reference's _transform_perts scale:
                # (adv_norm − clean_norm)/std (base_attacks.py:795)
                perts = pixel.scale_perts(x_norm - x_clean, channel_axis=1)
                reg = torch.sum(torch.abs(smooth(perts, kernel)))
                cost = ce + eta * reg + feat_coef * dist
            (g,) = torch.autograd.grad(cost, x_norm)
            return torch.stack([cost, ce, reg, dist]).detach(), g

        def refresh():
            with torch.no_grad():
                x_clean.copy_(pixel.normalize(clean01, channel_axis=1))
                _, taps = model.apply_norm_taps(x_clean)
                for held, t in zip(clean_taps, taps):
                    held.copy_(t)

        grad_fn.refresh = refresh
        return grad_fn

    def _attack_pieces(self, clean_pieces, label_pieces, devices):
        cfg = SignAttackConfig(epsilon=self.epsilon, steps=self.steps, step_size=self.step_size)
        ce_weight = 1.0 / len(clean_pieces)
        self._next_generator()  # TAP draws nothing; the call count moves as elsewhere
        key = loop_key(clean_pieces, devices, self._targeted)
        if key not in self._loops:
            self._loops[key] = SignLoop(
                lambda clean: [self._build_grad_fn(c, self._replica(d), ce_weight)
                               for c, d in zip(clean, devices)],
                clean_pieces, cfg, cost_sum=True, graphs=self.graphs)
        return self._loops[key].run(clean_pieces, label_pieces)

    def _record_costs(self, costs, video_names) -> None:
        if video_names is None or costs is None:
            return
        costs = costs.cpu().numpy()  # (steps, 4): total, ce, reg, dist
        for name in video_names:
            per_video = self.loss_info.setdefault(str(name), {})
            for i in range(costs.shape[0]):
                per_video[i] = {"cost": str(np.float32(costs[i, 0])),
                                "ce loss": str(np.float32(costs[i, 1])),
                                "reg_cost": str(np.float32(costs[i, 2])),
                                "distance": str(np.float32(costs[i, 3]))}
