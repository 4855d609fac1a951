"""Image-guided cross-modal attacks: I2V and ENS-I2V.

PyTorch counterpart of :mod:`i2v_tpu.attacks.i2v` (reference:
image_attacks.py:236-496):

  - clips are flattened once to an NCHW frame batch (B·T frames),
  - clean feature taps are computed once, without a graph,
  - surrogate forwards stop at the deepest tap,
  - each Adam step rebuilds the input through the hand-written kernel pair
    (:func:`i2v_tpu_torch.ops.kernels.rebuild_adv`: forward and backward),
    runs the surrogates, and steps ``torch.optim.Adam`` — the reference's own
    optimizer, which the JAX package matches through optax.

DR, AENS-I2V-MF and ILAF are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..models.api import ImageModel
from ..ops import kernels, losses, pixel
from .core import Attack

MODIFIER_INIT = 0.01 / 255  # reference: image_attacks.py:197,304,436


def run_adam_modifier_attack(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                             clean01_frames: torch.Tensor, *, steps: int, step_size: float,
                             epsilon: float):
    """Adam on an additive modifier of ``clean01_frames``.

    ``loss_fn(adv01_frames) -> cost`` (minimized). Returns ``(adv01_frames,
    costs)`` with ``costs`` the (steps,) cost before each update."""
    modifier = torch.full_like(clean01_frames, MODIFIER_INIT, requires_grad=True)
    opt = torch.optim.Adam([modifier], lr=step_size, betas=(0.9, 0.999), eps=1e-8,
                           foreach=False, fused=False)
    costs = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        cost = loss_fn(kernels.rebuild_adv(clean01_frames, modifier, epsilon))
        cost.backward()
        opt.step()
        costs.append(cost.detach())
    with torch.no_grad():
        adv01 = kernels.rebuild_adv(clean01_frames, modifier, epsilon)
    return adv01, torch.stack(costs).cpu().numpy() if costs else None


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
        raise NotImplementedError

    def _attack01(self, clean01, labels):
        # labels unused: the image-guided objectives are label-free feature
        # losses (the reference likewise ignores them, image_attacks.py:294-347)
        b = clean01.shape[0]
        frames = pixel.flatten_clip_to_frames(clean01)
        with torch.no_grad():
            clean_taps = _collect_taps(self.models, frames)
        adv_frames, costs = run_adam_modifier_attack(
            self._make_loss(clean_taps), frames, steps=self.steps,
            step_size=self.step_size, epsilon=self.epsilon)
        return pixel.unflatten_frames_to_clip(adv_frames, b), costs


class ImageGuidedFMDirection_Adam(_FrameAttack):
    """The I2V attack: minimize per-frame cosine similarity between adversarial
    and clean tap features (reference: image_attacks.py:236-364)."""

    def __init__(self, models: Sequence[ImageModel], step_size: float, epsilon=16 / 255,
                 steps=10):
        super().__init__("ImageGuidedFMDirection_Adam", models, epsilon, steps, step_size)

    def _make_loss(self, clean_taps):
        def loss_fn(adv01):
            return losses.i2v_cost(_collect_taps(self.models, adv01), clean_taps)

        return loss_fn


class ImageGuidedFML2_Adam_MultiModels(ImageGuidedFMDirection_Adam):
    """ENS-I2V: the same cosine objective summed over several surrogate
    models' taps; fixed step_size=0.005, steps=60
    (reference: image_attacks.py:366-496)."""

    def __init__(self, models: Sequence[ImageModel], epsilon=16 / 255, steps=60):
        super().__init__(models, step_size=0.005, epsilon=epsilon, steps=steps)
        self.attack = "ImageGuidedFML2_Adam_MultiModels"
