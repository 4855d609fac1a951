"""Attack base and the white-box sign-attack engine.

PyTorch counterpart of :mod:`i2v_tpu.attacks.core`. Attacks are callables
that take a *normalized-domain* clip batch ``(B, C, T, H, W)`` and labels and
return the normalized adversarial batch (base_attacks.py:226-234); inside,
everything runs in the [0,1] pixel domain. Per-step costs land in
``self.loss_info``.

:func:`run_sign_attack` is the iterative sign attack of the white-box
family, a Python step loop where the JAX package has one ``lax.scan``:
gradient → optional smoothing → gradient normalization → momentum → the
pixel update, which on the card is the hand-written kernel
(:func:`i2v_tpu_torch.ops.kernels.sign_step_project`). The gradient is
taken w.r.t. the normalized input, as the reference takes it; the
pixel-domain sign step is sign-equivalent, since normalization is a
positive per-channel affine map.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..ops import grads as grad_ops
from ..ops import kernels, losses, pixel

# grad_fn(adv01, labels, generator) -> (cost, grad w.r.t. adv01); the cost
# already carries the targeted sign (it is ascended); the generator (a CPU
# torch.Generator, or None) gives a step's random draws
GradFn = Callable[[torch.Tensor, torch.Tensor, torch.Generator],
                  tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class SignAttackConfig:
    """Hyper-parameters of the iterative sign attack family. Defaults follow
    the reference: ε=16/255, step_size=ε/steps (base_attacks.py:266-270)."""

    epsilon: float = 16 / 255
    steps: int = 10
    step_size: Optional[float] = None
    use_momentum: bool = False
    decay: float = 1.0
    # gradient normalization before momentum: 'frame' | 'clip' | 'l1' | None
    grad_norm: Optional[str] = None
    # accumulate the gradient over clip-batch chunks of this size: exact for
    # the mean-CE objectives (the mean of equal-chunk means is the global
    # mean), and it holds one chunk's activations at a time
    batch_chunk: Optional[int] = None

    @property
    def alpha(self) -> float:
        return self.step_size if self.step_size is not None else self.epsilon / self.steps


def _apply_grad_norm(g: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    if kind is None:
        return g
    if kind == "frame":
        return grad_ops.norm_grads(g, frame_level=True)
    if kind == "clip":
        return grad_ops.norm_grads(g, frame_level=False)
    if kind == "l1":
        return grad_ops.l1_normalize(g)
    raise ValueError(f"unknown grad_norm {kind!r}")


def _chunked(grad_fn: GradFn, b: int, chunk: int) -> GradFn:
    """``grad_fn`` over equal clip-batch chunks. A chunk that does not divide
    the batch (the trailing batch of a run) snaps to the largest divisor of
    the batch that fits, which keeps the accumulation exact.

    Every chunk starts from the generator state of the step, so all chunks
    see the step's one set of random draws (DI's transform), as the JAX
    engine hands the step's one key to every chunk."""
    if b % chunk:
        chunk = max(d for d in range(1, chunk + 1) if b % d == 0)
    k = b // chunk

    def chunked(adv, labels, generator):
        state = generator.get_state() if generator is not None else None
        costs, grads = [], []
        for i in range(k):
            if state is not None:
                generator.set_state(state)
            c, g = grad_fn(adv[i * chunk:(i + 1) * chunk], labels[i * chunk:(i + 1) * chunk],
                           generator)
            costs.append(c)
            grads.append(g)
        # global cost = mean of the chunk means; d(global)/d(chunk) =
        # (1/k)·d(chunk mean)/d(chunk)
        return torch.stack(costs).mean(0), torch.cat(grads) / k

    return chunked


def run_sign_attack(grad_fn: GradFn, clean01: torch.Tensor, labels: torch.Tensor,
                    cfg: SignAttackConfig, *,
                    smooth_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                    generator: Optional[torch.Generator] = None):
    """Run the iterative sign attack. Returns ``(adv01, per-step costs)``:
    the [0,1]-domain (B, C, T, H, W) adversarial clips and the cost before
    each update stacked over steps, (steps,) or (steps, k) for a vector cost
    such as TAP's, both on ``clean01``'s device. ``generator`` is handed to
    ``grad_fn`` each step for its random draws."""
    b = clean01.shape[0]
    if cfg.batch_chunk and cfg.batch_chunk < b:
        grad_fn = _chunked(grad_fn, b, cfg.batch_chunk)
    adv = clean01
    mom = torch.zeros_like(clean01) if cfg.use_momentum else None
    costs = []
    for _ in range(cfg.steps):
        cost, g = grad_fn(adv, labels, generator)
        if smooth_fn is not None:
            g = smooth_fn(g)
        g = _apply_grad_norm(g, cfg.grad_norm)
        if cfg.use_momentum:
            g = g + mom * cfg.decay
            mom = g
        adv = kernels.sign_step_project(adv, g, clean01, cfg.alpha, cfg.epsilon)
        costs.append(cost.detach())
    return adv, torch.stack(costs)


def ce_value_and_grad(apply_norm: Callable[[torch.Tensor], torch.Tensor], targeted: int = 1):
    """``(x_norm, labels) -> (targeted·CE, its gradient w.r.t. x_norm)``, the
    counterpart of ``jax.value_and_grad`` of the CE cost."""

    def value_and_grad(x_norm, labels):
        x_norm = x_norm.detach().requires_grad_(True)
        with torch.enable_grad():
            cost = targeted * losses.cross_entropy(apply_norm(x_norm), labels)
        (g,) = torch.autograd.grad(cost, x_norm)
        return cost.detach(), g

    return value_and_grad


def make_ce_grad_fn(apply_norm: Callable[[torch.Tensor], torch.Tensor],
                    targeted: int = 1) -> GradFn:
    """Cross-entropy gradient w.r.t. the *normalized-domain* input, as the
    reference takes it (base_attacks.py:284-287). ``apply_norm(clip_norm)
    -> logits``; cost = targeted·CE (ascended)."""
    value_and_grad = ce_value_and_grad(apply_norm, targeted)

    def grad_fn(adv01, labels, generator):
        return value_and_grad(pixel.normalize(adv01, channel_axis=1), labels)

    return grad_fn


class Attack:
    """Base class: the reference-compatible calling convention and attack
    modes. Subclasses implement ``_attack01(clean01, labels) -> (adv01,
    costs)`` on tensors on ``self.device``."""

    def __init__(self, name: str, model: Any = None, device: torch.device | str = "cpu"):
        self.attack = name
        self.model = model
        self.device = torch.device(device)
        self._targeted = 1
        self._attack_mode = "default"
        self._return_type = "float"
        self._target_map_function = None
        self._calls = 0
        self.loss_info: dict = {}

    # -- attack modes (reference: base_attacks.py:49-80) --------------------
    def set_attack_mode(self, mode: str, target_map_function=None) -> None:
        if mode == "default":
            self._attack_mode, self._targeted = "default", 1
        elif mode == "targeted":
            if target_map_function is None:
                raise ValueError("targeted mode requires a target_map_function")
            self._attack_mode, self._targeted = "targeted", -1
            self._target_map_function = target_map_function
        elif mode == "least_likely":
            self._attack_mode, self._targeted = "least_likely", -1
        else:
            raise ValueError(f"invalid attack mode {mode!r}")

    def _transform_labels(self, clean01, labels):
        # As in the JAX package (a conscious fix of the reference, whose
        # forwards never call their label transforms): targeted attacks the
        # mapped labels, least_likely the argmin class of the clean clip.
        if self._attack_mode == "targeted":
            return self._target_map_function(clean01, labels)
        if self._attack_mode == "least_likely":
            with torch.no_grad():
                return torch.argmin(self.model.apply01(clean01), dim=-1)
        return labels

    def _next_generator(self) -> torch.Generator:
        """A fresh but reproducible generator for each call, as the JAX
        engine folds its call count into the key (the reference redraws DI
        and TT randomness every batch). On the CPU, so that drawing a step's
        scalars never waits on the card."""
        generator = torch.Generator().manual_seed(self._calls)
        self._calls += 1
        return generator

    def set_return_type(self, type: str) -> None:
        """'float' (normalized clips) or 'int' (uint8 [0,255] pixel clips)
        (reference: base_attacks.py:82-93)."""
        if type not in ("float", "int"):
            raise ValueError(f"{type} is not a valid type. [Options: float, int]")
        self._return_type = type

    def save(self, save_dir: str, batches, verbose: bool = True) -> None:
        """Attack every batch and write ``{label}-adv.npy`` for each clip (the
        reference's Attack.save loop, base_attacks.py:95-136, on the artifact
        protocol). ``batches`` yields dicts with clips and labels."""
        from ..utils import artifacts

        correct = total = 0
        for step, batch in enumerate(batches):
            adv = self(batch["clips"], batch["labels"])
            if isinstance(adv, tuple):  # AENS returns (adv, used_time, cost_saved)
                adv = adv[0]
            if self._return_type == "int":
                # artifacts hold normalized float32 clips: back to that domain
                # first, as the JAX package does (the reference saves
                # adv.float()/255, the [0,1] domain, base_attacks.py:119-123)
                adv = pixel.normalize(adv.float() / 255, channel_axis=1)
            artifacts.save_batch(save_dir, batch["labels"], adv.detach().cpu().numpy())
            if verbose and hasattr(self.model, "apply_norm"):
                # image surrogates have no normalized-domain forward: no accuracy
                with torch.no_grad():
                    preds = torch.argmax(self.model.apply_norm(adv), dim=-1)
                labels = torch.as_tensor(batch["labels"], device=preds.device)
                total += int(labels.shape[0])
                correct += int(torch.sum(preds == labels))
                print(f"- Save Progress [{step + 1}] "
                      f"Accuracy: {100.0 * correct / max(total, 1):.2f} %")

    def _attack01(self, clean01, labels):
        raise NotImplementedError

    def _clean01(self, videos) -> torch.Tensor:
        """A normalized-domain clip batch (array or tensor), or a raw uint8
        (B,T,H,W,3) one (``--u8_ingress``, normalized on the device and
        bit-identical to the float32 path), → [0,1] float32 on
        ``self.device``."""
        if pixel.is_u8_clips(videos):
            return pixel.ingest_u8_clips(videos, self.device)
        if not isinstance(videos, torch.Tensor):
            videos = torch.from_numpy(np.array(videos, dtype=np.float32))
        return pixel.unnormalize(videos.to(self.device, torch.float32), channel_axis=1)

    def __call__(self, videos, labels, video_names=None) -> torch.Tensor:
        clean01 = self._clean01(videos)
        labels = torch.as_tensor(labels, device=self.device).long()
        labels = self._transform_labels(clean01, labels)
        adv01, costs = self._attack01(clean01, labels)
        self._record_costs(costs, video_names)
        if self._return_type == "int":
            return (adv01 * 255).to(torch.uint8)
        return pixel.normalize(adv01, channel_axis=1)

    def _record_costs(self, costs, video_names) -> None:
        if video_names is None or costs is None:
            return
        costs = costs.cpu().numpy() if isinstance(costs, torch.Tensor) else np.asarray(costs)
        for name in video_names:
            per_video = self.loss_info.setdefault(str(name), {})
            for i, c in enumerate(costs):
                per_video[i] = {"cost": str(np.float32(c))}

    def __str__(self):
        skip = {"model", "attack", "loss_info"}
        items = {k: v for k, v in self.__dict__.items()
                 if k not in skip and not k.startswith("_")}
        items["attack_mode"] = self._attack_mode
        body = ", ".join(f"{k}={v}" for k, v in items.items())
        return f"{self.attack}({body})"
