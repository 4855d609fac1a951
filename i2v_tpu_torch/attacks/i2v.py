"""Image-guided cross-modal attacks: DR, I2V, ENS-I2V, AENS-I2V-MF, ILAF.

PyTorch counterpart of :mod:`i2v_tpu.attacks.i2v` (reference:
image_attacks.py:129-629, TPAMI_attack.py:141-320):

  - clips are flattened once to an NCHW frame batch (B·T frames),
  - clean feature taps are computed once, without a graph,
  - surrogate forwards stop at the deepest tap,
  - each Adam step rebuilds the input through the hand-written kernel pair
    (:func:`i2v_tpu_torch.ops.kernels.rebuild_adv`: forward and backward),
    runs the surrogates, and steps Adam as ``torch.optim.Adam`` does — the
    reference's own optimizer, which the JAX package matches through optax —
    from a device table of its per-step scalars
    (:class:`~i2v_tpu_torch.utils.graphs.TableAdam`),
  - ILAF fine-tunes an existing adversarial clip on a video model by sign
    descent, rebuilding the 5-D clip through the same kernel pair,
  - each step after the first is a CUDA graph on a card, and each attack
    keeps its loop, buffers and graph, one a clip shape, as the JAX
    package keeps one jitted loop a shape (``_jit_cache``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..models.api import ImageModel, VideoModel
from ..ops import kernels, losses, pixel
from ..utils.graphs import StepGraph, TableAdam
from ..utils.profiling import next_number, span
from .core import Attack

MODIFIER_INIT = 0.01 / 255  # reference: image_attacks.py:197,304,436


class AdamModifierLoop:
    """:func:`run_adam_modifier_attack`'s static buffers and step for one
    frame batch: the frames, the modifier and Adam's state
    (:class:`~i2v_tpu_torch.utils.graphs.TableAdam`), the attack's state and
    one ``(steps, …)`` buffer a record, written at the device step counter.
    The step is a CUDA graph on a card (``graphs``) and eager elsewhere.
    :meth:`run` resets the buffers, so that a new batch copied into
    ``frames`` replays the same graph."""

    def __init__(self, loss_fn: Callable, frames: torch.Tensor, *, steps: int, step_size: float,
                 epsilon: float, graphs: bool = True):
        self.loss_fn, self.frames, self.steps, self.epsilon = loss_fn, frames, steps, epsilon
        self.modifier = torch.full_like(frames, MODIFIER_INIT)
        self.adam = TableAdam(self.modifier, step_size, steps)
        self.state = None
        self.records = None
        self.graph = StepGraph(self._step, frames.device, enabled=graphs)

    def _step(self) -> None:
        m = self.modifier.detach().requires_grad_(True)
        with torch.enable_grad():
            cost, (state, record) = self.loss_fn(
                kernels.rebuild_adv(self.frames, m, self.epsilon), self.state)
        (g,) = torch.autograd.grad(cost, m)
        with torch.no_grad():
            for held, new in zip(self.state or (), state or ()):
                held.copy_(new)
            record = record if isinstance(record, tuple) else (record,)
            if self.records is None:  # step 0 is eager: made outside any capture
                self.records = [torch.empty((self.steps,) + r.shape, dtype=r.dtype,
                                            device=r.device) for r in record]
            for held, r in zip(self.records, record):
                held.index_copy_(0, self.adam.k, r.detach().unsqueeze(0))
        self.adam.step(g)

    def run(self, state0: Any = None):
        """→ (adv01 frames, records stacked over steps, final state)."""
        self.modifier.fill_(MODIFIER_INIT)
        self.adam.reset()
        if state0 is not None:
            if self.state is None:
                self.state = tuple(s.detach().clone() for s in state0)
            else:
                for held, s in zip(self.state, state0):
                    held.copy_(s)
        device = self.frames.device
        with span("i2v.steps", device=device):
            for _ in range(self.steps):
                self.graph()
        with span("i2v.handback", device=device):
            with torch.no_grad():
                adv01 = kernels.rebuild_adv(self.frames, self.modifier, self.epsilon)
            records = None
            if self.steps:
                records = tuple(r.clone() for r in self.records)
                records = records if len(records) > 1 else records[0]
            state = None if self.state is None else tuple(s.clone() for s in self.state)
        return adv01, records, state


def run_adam_modifier_attack(loss_fn: Callable, clean01_frames: torch.Tensor, *, steps: int,
                             step_size: float, epsilon: float, state0: Any = None,
                             graphs: bool = True):
    """Adam on an additive modifier of ``clean01_frames``.

    ``loss_fn(adv01_frames, state) -> (cost, (new_state, record))``: the cost
    is minimized, ``state`` (a tuple of tensors) carries an attack's adaptive
    variables (AENS's coefficients) from step to step, and ``record`` (a
    tensor or a tuple of tensors) is kept for each step. ``loss_fn`` must be
    capture-ready (:mod:`i2v_tpu_torch.utils.graphs`). Returns
    ``(adv01_frames, records, final_state)``, the records stacked over steps
    on the device. Adam is ``torch.optim.Adam(lr=step_size, betas=(0.9,
    0.999), eps=1e-8)``, the reference's optimizer, as a device-table step."""
    loop = AdamModifierLoop(loss_fn, clean01_frames, steps=steps, step_size=step_size,
                            epsilon=epsilon, graphs=graphs)
    return loop.run(state0)


def _collect_taps(models: Sequence[ImageModel], frames01):
    taps = []
    for m in models:
        _, t = m.apply01_taps(frames01)
        taps.extend(t)
    return taps


class _FrameAttack(Attack):
    """Shared plumbing: clip→frame flattening, clean taps, the Adam loop."""

    def __init__(self, name: str, models: Sequence[ImageModel], epsilon: float, steps: int,
                 step_size: float, graphs: bool = True):
        models = list(models)
        super().__init__(name, models[0] if models else None,
                         device=models[0].device if models else "cpu")
        self.models = models
        self.epsilon = epsilon
        self.steps = steps
        self.step_size = step_size
        self.graphs = graphs
        # (frame shape) → (AdamModifierLoop, its clean taps), as JAX's _jit_cache
        self._loops: dict = {}

    def _make_loss(self, clean_taps):
        """``loss_fn(adv01_frames, state) -> (cost, (new_state, record))``."""
        raise NotImplementedError

    def _state0(self):
        return None

    def _run(self, clean01):
        """→ (adv01 clips, stacked per-step records, final state)."""
        with span("i2v.call", unit=next_number("i2v.call"), device=clean01.device):
            b = clean01.shape[0]
            with span("i2v.clean_taps", device=clean01.device):
                frames = pixel.flatten_clip_to_frames(clean01)
                key = tuple(frames.shape)
                if key not in self._loops:
                    with span("setup.warm", unit=next_number("setup.warm"), always=True):
                        with torch.no_grad():
                            clean_taps = _collect_taps(self.models, frames)
                        self._loops[key] = (AdamModifierLoop(
                            self._make_loss(clean_taps), frames, steps=self.steps,
                            step_size=self.step_size, epsilon=self.epsilon,
                            graphs=self.graphs), clean_taps)
                        if frames.is_cuda:
                            torch.cuda.synchronize(frames.device)
                else:
                    loop, clean_taps = self._loops[key]
                    loop.frames.copy_(frames)
                    with torch.no_grad():
                        for held, new in zip(clean_taps, _collect_taps(self.models, loop.frames)):
                            held.copy_(new)
            adv_frames, records, state = self._loops[key][0].run(self._state0())
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
                 steps=10, graphs: bool = True):
        super().__init__("ImageGuidedStd_Adam", models, epsilon, steps, step_size, graphs)

    def _make_loss(self, clean_taps):
        def loss_fn(adv01, state):
            cost = losses.dispersion_cost(_collect_taps(self.models, adv01))
            return cost, (state, cost)

        return loss_fn


class ImageGuidedFMDirection_Adam(_FrameAttack):
    """The I2V attack: minimize per-frame cosine similarity between adversarial
    and clean tap features (reference: image_attacks.py:236-364)."""

    def __init__(self, models: Sequence[ImageModel], step_size: float, epsilon=16 / 255,
                 steps=10, graphs: bool = True):
        super().__init__("ImageGuidedFMDirection_Adam", models, epsilon, steps, step_size,
                         graphs)

    def _make_loss(self, clean_taps):
        def loss_fn(adv01, state):
            cost = losses.i2v_cost(_collect_taps(self.models, adv01), clean_taps)
            return cost, (state, cost)

        return loss_fn


class ImageGuidedFML2_Adam_MultiModels(ImageGuidedFMDirection_Adam):
    """ENS-I2V: the same cosine objective summed over several surrogate
    models' taps; fixed step_size=0.005, steps=60
    (reference: image_attacks.py:366-496)."""

    def __init__(self, models: Sequence[ImageModel], epsilon=16 / 255, steps=60,
                 graphs: bool = True):
        super().__init__(models, step_size=0.005, epsilon=epsilon, steps=steps, graphs=graphs)
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
                 coef_CE: bool = False, epsilon=16 / 255, steps=60, graphs: bool = True):
        super().__init__("AENS_I2V_MF", models, epsilon, steps, step_size, graphs)
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
                 epsilon=16 / 255, steps=60, graphs: bool = True):
        super().__init__("ILAF", model, device=model.device)
        self.model_type = model_type
        self.epsilon = epsilon
        self.steps = steps
        self.step_size = step_size
        self.graphs = graphs
        self._loops: dict = {}  # clip shape → _ILAFLoop

    def save(self, save_dir, batches, verbose: bool = True) -> None:
        # the inherited loop calls self(clips, labels), but ILAF takes
        # (videos, ori_videos, labels): fail with intent, not in the pixel math
        raise NotImplementedError(
            "ILAF consumes PAIRED (adv, ori) artifact batches, not raw "
            "clips (image_fine_tune_attack.py:73-82) — drive it through "
            "cli.fine_tune, which pairs {id}-adv.npy with {id}-ori.npy")

    def _references(self, adv01: torch.Tensor, clean01: torch.Tensor) -> tuple:
        """(clean taps, starting feature directions, their norms), computed
        once a clip batch, without a graph."""
        with torch.no_grad():
            _, clean_taps = self.model.apply01_taps(clean01)
            _, adv_taps = self.model.apply01_taps(adv01)
            init_dirs, init_norms = losses.feature_delta_direction(adv_taps, clean_taps)
        return list(clean_taps), list(init_dirs), list(init_norms)

    def make_cost(self, adv01: torch.Tensor, clean01: torch.Tensor):
        """``cost(modifier)`` of the fine-tune: the clean and starting taps
        are computed here, once, without a graph."""
        refs = self._references(adv01, clean01)
        return lambda modifier: self._cost(clean01, modifier, refs)

    def _cost(self, clean01, modifier, refs):
        _, taps = self.model.apply01_taps(kernels.rebuild_adv(clean01, modifier, self.epsilon))
        return losses.ilaf_cost(taps, *refs)

    def _fine_tune(self, adv01, clean01):
        """→ (out01, (steps,) costs, each before its update)."""
        key = tuple(adv01.shape)
        loop = self._loops.get(key)
        if loop is None:
            loop = self._loops[key] = _ILAFLoop(self, adv01, clean01)
        else:
            loop.load(adv01, clean01)
        return loop.run()

    def __call__(self, videos, ori_videos, labels, video_names=None):
        adv01 = self._clean01(videos)
        clean01 = self._clean01(ori_videos)
        out01, costs = self._fine_tune(adv01, clean01)
        self._record_costs(costs, video_names)
        return pixel.normalize(out01, channel_axis=1)


class _ILAFLoop:
    """ILAF's static buffers and step for one clip shape: the clean and
    starting clips, the modifier, the references of :meth:`ILAF._references`
    and the ``(steps,)`` costs, written at a device step counter. A CUDA
    graph on a card, eager elsewhere; :meth:`load` takes a new batch."""

    def __init__(self, attack: ILAF, adv01: torch.Tensor, clean01: torch.Tensor):
        self.attack = attack
        self.adv01, self.clean01 = adv01, clean01
        self.refs = attack._references(adv01, clean01)
        self.modifier = torch.empty_like(clean01)
        self.costs = torch.zeros(attack.steps, device=clean01.device)
        self.k = torch.zeros(1, dtype=torch.long, device=clean01.device)
        self.alpha32 = float(np.float32(attack.step_size))
        self.graph = StepGraph(self._step, clean01.device, enabled=attack.graphs)

    def load(self, adv01: torch.Tensor, clean01: torch.Tensor) -> None:
        self.adv01.copy_(adv01)
        self.clean01.copy_(clean01)
        for held, new in zip(self.refs, self.attack._references(self.adv01, self.clean01)):
            for h, n in zip(held, new):
                h.copy_(n)

    def _step(self) -> None:
        m = self.modifier.detach().requires_grad_(True)
        with torch.enable_grad():
            cost = self.attack._cost(self.clean01, m, self.refs)
        (g,) = torch.autograd.grad(cost, m)
        with torch.no_grad():
            self.modifier.sub_(self.alpha32 * pixel.sign_keep_nan(g))
            self.costs.index_copy_(0, self.k, cost.detach().reshape(1))
            self.k.add_(1)

    def run(self):
        # the existing perturbation (image_attacks.py:573)
        torch.sub(self.adv01, self.clean01, out=self.modifier)
        self.k.zero_()
        for _ in range(self.attack.steps):
            self.graph()
        with torch.no_grad():
            out01 = kernels.rebuild_adv(self.clean01, self.modifier, self.attack.epsilon)
        return out01, self.costs.clone() if self.attack.steps else None
