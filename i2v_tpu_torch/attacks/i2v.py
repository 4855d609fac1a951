"""Image-guided cross-modal attacks: DR, I2V, ENS-I2V, AENS-I2V-MF, ILAF.

PyTorch counterpart of :mod:`i2v_tpu.attacks.i2v` (reference:
image_attacks.py:129-629, TPAMI_attack.py:141-320):

  - clips are flattened once to an NCHW frame batch (B·T frames),
  - clean feature taps are computed once, without a graph,
  - surrogate forwards stop at the deepest tap,
  - each Adam step rebuilds the input through the hand-written kernel pair
    (:func:`i2v_tpu_torch.ops.kernels.rebuild_adv`: forward and backward),
    runs the surrogates, and steps ``torch.optim.Adam`` — the reference's own
    optimizer, which the JAX package matches through optax,
  - ILAF fine-tunes an existing adversarial clip on a video model by sign
    descent, rebuilding the 5-D clip through the same kernel pair.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..models.api import ImageModel, VideoModel
from ..ops import kernels, losses, pixel
from .core import Attack

MODIFIER_INIT = 0.01 / 255  # reference: image_attacks.py:197,304,436


def _detached(record):
    if isinstance(record, tuple):
        return tuple(r.detach() for r in record)
    return record.detach()


def _stacked(records: list):
    if not records:
        return None
    if isinstance(records[0], tuple):
        return tuple(torch.stack(r) for r in zip(*records))
    return torch.stack(records)


def run_adam_modifier_attack(loss_fn: Callable, clean01_frames: torch.Tensor, *, steps: int,
                             step_size: float, epsilon: float, state0: Any = None):
    """Adam on an additive modifier of ``clean01_frames``.

    ``loss_fn(adv01_frames, state) -> (cost, (new_state, record))``: the cost
    is minimized, ``state`` carries an attack's adaptive variables (AENS's
    coefficients) from step to step, and ``record`` (a tensor or a tuple of
    tensors) is kept for each step. Returns ``(adv01_frames, records,
    final_state)``, the records stacked over steps on the device."""
    modifier = torch.full_like(clean01_frames, MODIFIER_INIT, requires_grad=True)
    opt = torch.optim.Adam([modifier], lr=step_size, betas=(0.9, 0.999), eps=1e-8,
                           foreach=False, fused=False)
    state, records = state0, []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        cost, (state, record) = loss_fn(kernels.rebuild_adv(clean01_frames, modifier, epsilon),
                                        state)
        cost.backward()
        opt.step()
        records.append(_detached(record))
    with torch.no_grad():
        adv01 = kernels.rebuild_adv(clean01_frames, modifier, epsilon)
    return adv01, _stacked(records), state


def _collect_taps(models: Sequence[ImageModel], frames01):
    taps = []
    for m in models:
        _, t = m.apply01_taps(frames01)
        taps.extend(t)
    return taps


class _FrameAttack(Attack):
    """Shared plumbing: clip→frame flattening, clean taps, the Adam loop."""

    def __init__(self, name: str, models: Sequence[ImageModel], epsilon: float, steps: int,
                 step_size: float):
        models = list(models)
        super().__init__(name, models[0] if models else None,
                         device=models[0].device if models else "cpu")
        self.models = models
        self.epsilon = epsilon
        self.steps = steps
        self.step_size = step_size

    def _make_loss(self, clean_taps):
        """``loss_fn(adv01_frames, state) -> (cost, (new_state, record))``."""
        raise NotImplementedError

    def _state0(self):
        return None

    def _run(self, clean01):
        """→ (adv01 clips, stacked per-step records, final state)."""
        b = clean01.shape[0]
        frames = pixel.flatten_clip_to_frames(clean01)
        with torch.no_grad():
            clean_taps = _collect_taps(self.models, frames)
        adv_frames, records, state = run_adam_modifier_attack(
            self._make_loss(clean_taps), frames, steps=self.steps, step_size=self.step_size,
            epsilon=self.epsilon, state0=self._state0())
        return pixel.unflatten_frames_to_clip(adv_frames, b), records, state

    def _attack01(self, clean01, labels):
        # labels unused: the image-guided objectives are label-free feature
        # losses (the reference likewise ignores them, image_attacks.py:294-347)
        adv01, costs, _ = self._run(clean01)
        return adv01, costs


class ImageGuidedStd_Adam(_FrameAttack):
    """Dispersion Reduction: minimize Σ std(tap activations)
    (reference: image_attacks.py:129-234)."""

    def __init__(self, models: Sequence[ImageModel], step_size: float, epsilon=16 / 255,
                 steps=10):
        super().__init__("ImageGuidedStd_Adam", models, epsilon, steps, step_size)

    def _make_loss(self, clean_taps):
        def loss_fn(adv01, state):
            cost = losses.dispersion_cost(_collect_taps(self.models, adv01))
            return cost, (state, cost)

        return loss_fn


class ImageGuidedFMDirection_Adam(_FrameAttack):
    """The I2V attack: minimize per-frame cosine similarity between adversarial
    and clean tap features (reference: image_attacks.py:236-364)."""

    def __init__(self, models: Sequence[ImageModel], step_size: float, epsilon=16 / 255,
                 steps=10):
        super().__init__("ImageGuidedFMDirection_Adam", models, epsilon, steps, step_size)

    def _make_loss(self, clean_taps):
        def loss_fn(adv01, state):
            cost = losses.i2v_cost(_collect_taps(self.models, adv01), clean_taps)
            return cost, (state, cost)

        return loss_fn


class ImageGuidedFML2_Adam_MultiModels(ImageGuidedFMDirection_Adam):
    """ENS-I2V: the same cosine objective summed over several surrogate
    models' taps; fixed step_size=0.005, steps=60
    (reference: image_attacks.py:366-496)."""

    def __init__(self, models: Sequence[ImageModel], epsilon=16 / 255, steps=60):
        super().__init__(models, step_size=0.005, epsilon=epsilon, steps=steps)
        self.attack = "ImageGuidedFML2_Adam_MultiModels"


class AENS_I2V_MF(_FrameAttack):
    """Adaptive ENS-I2V with multi-layer taps and per-step coefficient
    re-weighting: coeffs = softmax(softmax(prev_loss) + momentum·coeffs),
    before each step's loss (reference: TPAMI_attack.py:141-320).

    ``__call__`` returns ``(adv, used_time, cost_saved)`` like the reference
    (TPAMI_attack.py:320); the coefficients of each step are kept in
    ``self.weights``. ``self.coeffs`` persists across calls, as the
    reference's instance state does (TPAMI_attack.py:165 sets it once, :265
    updates it): clip N+1's first step sees clip N's last coefficients. The
    previous per-tap loss resets to ones on every call (:257).
    """

    def __init__(self, models: Sequence[ImageModel], step_size: float, momentum: float = 0.0,
                 coef_CE: bool = False, epsilon=16 / 255, steps=60):
        super().__init__("AENS_I2V_MF", models, epsilon, steps, step_size)
        self.momentum = momentum
        self.coef_CE = coef_CE
        self.n_taps = sum(len(m.tap_keys) for m in self.models)
        self.weights: list = []
        self.coeffs = torch.ones(self.n_taps, dtype=torch.float32, device=self.device)

    def set_return_type(self, type: str) -> None:
        # the reference's AENS sits on the slim image-attack base, whose
        # forward has no int/float machinery (TPAMI_attack.py:16-139)
        if type != "float":
            raise NotImplementedError(
                "AENS_I2V_MF always returns the normalized-domain triple "
                "(adv, used_time, cost_saved) (TPAMI_attack.py:314-320); "
                "the int return type is a video-attack-base contract it never had")
        super().set_return_type(type)

    def _state0(self):
        prev = torch.ones(self.n_taps, dtype=torch.float32, device=self.device)
        return self.coeffs, prev

    def _make_loss(self, clean_taps):
        momentum, coef_ce = self.momentum, self.coef_CE

        def loss_fn(adv01, state):
            coeffs, prev = state
            coeffs = torch.softmax(torch.softmax(prev, dim=0) + momentum * coeffs, dim=0)
            per_tap = losses.per_tap_frame_cosines(_collect_taps(self.models, adv01),
                                                   clean_taps)          # (taps, B·T)
            each = torch.sum(coeffs[:, None] * per_tap, dim=1)           # (taps,)
            cost = torch.mean(each)
            new_prev = (each if coef_ce else torch.sum(per_tap, dim=1)).detach()
            return cost, ((coeffs, new_prev), (cost, coeffs))

        return loss_fn

    def __call__(self, videos, labels, video_names=None):
        clean01 = self._clean01(videos)
        begin = time.time()
        adv01, (costs, coeffs), (final_coeffs, _) = self._run(clean01)
        # the host clock stops on a sync on the small per-step cost vector
        cost_saved = costs.cpu().numpy()
        used_time = time.time() - begin
        self.coeffs = final_coeffs
        self.weights = list(coeffs.cpu().numpy())
        self._record_costs(cost_saved, video_names)
        return pixel.normalize(adv01, channel_axis=1), used_time, cost_saved


class ILAF(Attack):
    """Intermediate-Level Attack (Flexible): fine-tune an existing adversarial
    clip to amplify its mid-layer feature displacement on the white-box video
    model (reference: image_attacks.py:498-629).

    loss per tap = −(0.5·‖Δ_step‖/‖Δ_init‖ + ⟨dir_init, dir_step⟩); sign
    descent on the modifier ``adv − clean`` (no Adam, no ε projection of the
    modifier: the rebuild's clamps bound the clip, as in the reference and
    the JAX package). The reference's output-reshape layout scramble
    (image_attacks.py:625-628) is not reproduced (SURVEY.md C20).
    """

    def __init__(self, model: VideoModel, model_type: str = "", step_size=0.005,
                 epsilon=16 / 255, steps=60):
        super().__init__("ILAF", model, device=model.device)
        self.model_type = model_type
        self.epsilon = epsilon
        self.steps = steps
        self.step_size = step_size

    def save(self, save_dir, batches, verbose: bool = True) -> None:
        # the inherited loop calls self(clips, labels), but ILAF takes
        # (videos, ori_videos, labels): fail with intent, not in the pixel math
        raise NotImplementedError(
            "ILAF consumes PAIRED (adv, ori) artifact batches, not raw "
            "clips (image_fine_tune_attack.py:73-82) — drive it through "
            "cli.fine_tune, which pairs {id}-adv.npy with {id}-ori.npy")

    def make_cost(self, adv01: torch.Tensor, clean01: torch.Tensor):
        """``cost(modifier)`` of the fine-tune: the clean and starting taps
        are computed here, once, without a graph."""
        with torch.no_grad():
            _, clean_taps = self.model.apply01_taps(clean01)
            _, adv_taps = self.model.apply01_taps(adv01)
            init_dirs, init_norms = losses.feature_delta_direction(adv_taps, clean_taps)

        def cost_fn(modifier):
            _, taps = self.model.apply01_taps(kernels.rebuild_adv(clean01, modifier,
                                                                  self.epsilon))
            return losses.ilaf_cost(taps, clean_taps, init_dirs, init_norms)

        return cost_fn

    def _fine_tune(self, adv01, clean01):
        """→ (out01, (steps,) costs, each before its update)."""
        cost_fn = self.make_cost(adv01, clean01)
        alpha32 = float(np.float32(self.step_size))
        modifier = adv01 - clean01  # the existing perturbation (image_attacks.py:573)
        costs = []
        for _ in range(self.steps):
            m = modifier.detach().requires_grad_(True)
            cost = cost_fn(m)
            (g,) = torch.autograd.grad(cost, m)
            modifier = modifier - alpha32 * pixel.sign_keep_nan(g)
            costs.append(cost.detach())
        with torch.no_grad():
            out01 = kernels.rebuild_adv(clean01, modifier, self.epsilon)
        return out01, torch.stack(costs) if costs else None

    def __call__(self, videos, ori_videos, labels, video_names=None):
        adv01 = self._clean01(videos)
        clean01 = self._clean01(ori_videos)
        out01, costs = self._fine_tune(adv01, clean01)
        self._record_costs(costs, video_names)
        return pixel.normalize(out01, channel_axis=1)
