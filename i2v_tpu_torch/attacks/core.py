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

White-box data parallelism: a clip batch laid out over a mesh's ``data``
axis (``parallel.mesh.shard_clips``) goes into an attack as it is, as the
JAX package's attacks take a sharded batch. :func:`run_sign_attack_pieces`
runs each piece on its own device, through the attack's video-model
replica there (:class:`~i2v_tpu_torch.parallel.replicas.Replicas`, built
once an attack): the step's cost is the mean of the piece means (TAP's, a
sum of per-clip terms and a CE mean, is summed), each piece's gradient is
its share of the whole batch's, every piece draws the step's one set of
random numbers, and smoothing, the per-clip normalizations, momentum and
the sign step (the kernel, once a piece a step) run on the piece's device;
only the whole-batch L1 normalization sums one scalar across the pieces.
The result comes back as whole clips on the mesh's first device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional, Sequence

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
    (adv,), costs = run_sign_attack_pieces([grad_fn], [clean01], [labels], cfg,
                                           smooth_fn=smooth_fn, generator=generator)
    return adv, costs


def run_sign_attack_pieces(grad_fns: Sequence[GradFn], clean_pieces: Sequence[torch.Tensor],
                           label_pieces: Sequence[torch.Tensor], cfg: SignAttackConfig, *,
                           smooth_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                           generator: Optional[torch.Generator] = None,
                           cost_sum: bool = False):
    """The sign attack over a clip batch held as equal pieces, each on its
    own device with its own ``grad_fn`` (one piece: the one-device attack).
    Returns ``(adv01 pieces, per-step costs)``, the costs on the first
    piece's device.

    With ``cost_sum=False`` each ``grad_fn``'s cost is a mean over its clips:
    the step's cost is the mean of the piece costs and each piece's gradient
    is divided by the piece count, as :func:`_chunked` does. With
    ``cost_sum=True`` each ``grad_fn`` already returns its share of the whole
    batch's cost and gradient (TAP's), and the costs are summed. Every piece
    starts from the step's generator state, so that all see the step's one
    set of random draws."""
    k = len(clean_pieces)
    home = clean_pieces[0].device
    fns = []
    for fn, clean in zip(grad_fns, clean_pieces):
        b = clean.shape[0]
        fns.append(_chunked(fn, b, cfg.batch_chunk) if cfg.batch_chunk and cfg.batch_chunk < b
                   else fn)
    adv = list(clean_pieces)
    mom = [torch.zeros_like(c) for c in clean_pieces] if cfg.use_momentum else None
    costs = []
    for _ in range(cfg.steps):
        state = generator.get_state() if generator is not None and k > 1 else None
        step_costs, gs = [], []
        for fn, a, lab in zip(fns, adv, label_pieces):
            if state is not None:
                generator.set_state(state)
            cost, g = fn(a, lab, generator)
            if k > 1 and not cost_sum:
                g = g / k
            if smooth_fn is not None:
                g = smooth_fn(g)
            step_costs.append(cost.detach())
            gs.append(g)
        gs = _normalize_pieces(gs, cfg.grad_norm, home)
        for i, g in enumerate(gs):
            if cfg.use_momentum:
                g = g + mom[i] * cfg.decay
                mom[i] = g
            adv[i] = kernels.sign_step_project(adv[i], g, clean_pieces[i], cfg.alpha,
                                               cfg.epsilon)
        costs.append(_reduce_costs(step_costs, home, cost_sum))
    return adv, torch.stack(costs)


def _normalize_pieces(gs: list, kind: Optional[str], home: torch.device) -> list:
    """The gradient normalization of each piece. The per-frame and per-clip
    ones need only the piece; the whole-tensor L1 divides every piece by the
    Σ|g| of the whole batch, summed in piece order on ``home``."""
    if kind != "l1" or len(gs) == 1:
        return [_apply_grad_norm(g, kind) for g in gs]
    from ..parallel.mesh import move

    total = torch.stack([move(torch.sum(torch.abs(g)), home) for g in gs]).sum()
    return [grad_ops.l1_normalize(g, move(total, g.device)) for g in gs]


def _reduce_costs(costs: list, home: torch.device, cost_sum: bool) -> torch.Tensor:
    if len(costs) == 1:
        return costs[0]
    from ..parallel.mesh import move

    stacked = torch.stack([move(c, home) for c in costs])
    return stacked.sum(0) if cost_sum else stacked.mean(0)


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
        self._mesh = None
        self._replicas = None
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

    def set_mesh(self, mesh) -> None:
        """Run over ``mesh``'s ``data`` axis: a batch handed to the attack
        whole is laid out as ``parallel.mesh.shard_clips`` lays it, or, where
        it does not divide over the axis, runs whole on the mesh's first
        device, with a warning. ``None`` turns it off. A batch that comes
        laid out already (a ``Sharded``) runs over its own mesh either way."""
        self._mesh = mesh

    def _replica(self, device: torch.device):
        """The attack's model on ``device``: the model itself on its own
        device, elsewhere a copy built at first use and kept."""
        if self._replicas is None:
            from ..parallel.replicas import Replicas

            self._replicas = Replicas(self.model)
        return self._replicas.on(device)

    def _transform_labels(self, clean01, labels, device: Optional[torch.device] = None):
        # As in the JAX package (a conscious fix of the reference, whose
        # forwards never call their label transforms): targeted attacks the
        # mapped labels, least_likely the argmin class of the clean clip.
        if self._attack_mode == "targeted":
            return self._target_map_function(clean01, labels)
        if self._attack_mode == "least_likely":
            with torch.no_grad():
                model = self.model if device is None else self._replica(device)
                return torch.argmin(model.apply01(clean01), dim=-1)
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
        (adv01,), costs = self._attack_pieces([clean01], [labels], [self.device])
        return adv01, costs

    def _attack_pieces(self, clean_pieces, label_pieces, devices):
        """Attack a clip batch held as pieces, each on its device →
        (adversarial pieces, per-step costs on the first device)."""
        raise NotImplementedError(f"{self.attack} does not run over a device mesh")

    def _clean01(self, videos, device: Optional[torch.device] = None) -> torch.Tensor:
        """A normalized-domain clip batch (array or tensor), or a raw uint8
        (B,T,H,W,3) one (``--u8_ingress``, normalized on the device and
        bit-identical to the float32 path), → [0,1] float32 on ``device``
        (default ``self.device``)."""
        device = self.device if device is None else device
        if pixel.is_u8_clips(videos):
            return pixel.ingest_u8_clips(videos, device)
        if not isinstance(videos, torch.Tensor):
            videos = torch.from_numpy(np.array(videos, dtype=np.float32))
        return pixel.unnormalize(videos.to(device, torch.float32), channel_axis=1)

    def _laid_out(self, videos):
        """``(clip pieces, the device of each)`` where the batch runs over a
        mesh (a ``Sharded`` over the ``data`` axis, or a whole batch under
        :meth:`set_mesh`), else None."""
        from ..parallel.mesh import Sharded, clip_sharding

        if isinstance(videos, Sharded):
            sharding = videos.sharding
            if sharding.axes != ("data",):
                raise ValueError(f"a white-box attack takes clips laid out over the mesh's "
                                 f"'data' axis (shard_clips), not over {sharding.axes}")
            pieces = videos.distinct_pieces()
        elif self._mesh is None:
            return None
        else:
            sharding = clip_sharding(self._mesh)
            if len(videos) % sharding.n_pieces:
                warnings.warn(
                    f"{self.attack}: batch of {len(videos)} does not divide the mesh's "
                    f"{sharding.n_pieces}-way data axis; running this batch on a single "
                    "device (pick a batch size divisible by the data axis to keep the "
                    "attack data-parallel)")
                return [videos], [self._mesh.positions[0]]
            pieces = sharding.split(torch.as_tensor(videos)).distinct_pieces()
        piece_of, positions = sharding.piece_of(), sharding.mesh.positions
        return pieces, [positions[piece_of.index(i)] for i in range(sharding.n_pieces)]

    def __call__(self, videos, labels, video_names=None) -> torch.Tensor:
        laid = self._laid_out(videos)
        if laid is None:
            clean01 = self._clean01(videos)
            labels = torch.as_tensor(labels, device=self.device).long()
            labels = self._transform_labels(clean01, labels)
            adv01, costs = self._attack01(clean01, labels)
        else:
            from ..parallel.mesh import move

            pieces, devices = laid
            labels = torch.as_tensor(labels).long()
            per = labels.shape[0] // len(pieces)
            clean, piece_labels = [], []
            for i, (piece, dev) in enumerate(zip(pieces, devices)):
                clean.append(self._clean01(piece, dev))
                piece_labels.append(self._transform_labels(
                    clean[-1], move(labels[i * per:(i + 1) * per], dev), dev))
            adv_pieces, costs = self._attack_pieces(clean, piece_labels, devices)
            adv01 = torch.cat([move(a, devices[0]) for a in adv_pieces])
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
