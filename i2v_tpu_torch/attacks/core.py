"""Attack base and the white-box sign-attack engine.

PyTorch counterpart of :mod:`i2v_tpu.attacks.core`. Attacks are callables
that take a *normalized-domain* clip batch ``(B, C, T, H, W)`` and labels and
return the normalized adversarial batch (base_attacks.py:226-234); inside,
everything runs in the [0,1] pixel domain. Per-step costs land in
``self.loss_info``.

:func:`run_sign_attack` is the iterative sign attack of the white-box
family, a step loop where the JAX package has one ``lax.scan``: gradient →
optional smoothing → gradient normalization → momentum → the pixel update,
which on the card is the hand-written kernel
(:func:`i2v_tpu_torch.ops.kernels.sign_step_project`). The attacks keep its
buffers a batch layout (:class:`SignLoop`), and on a card each step after
the first is a CUDA graph replayed (:mod:`i2v_tpu_torch.utils.graphs`), as
the JAX engine is one ``jit`` a shape. The gradient is
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
its share of the whole batch's, every piece reads the step's one row of
random draws, and smoothing, the per-clip normalizations, momentum and
the sign step (the kernel, once a piece a step) run on the piece's device;
only the whole-batch L1 normalization sums one scalar across the pieces.
The result comes back as whole clips on the mesh's first device.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..ops import grads as grad_ops
from ..ops import kernels, losses, pixel
from ..utils.graphs import DrawTable, StepGraph

# grad_fn(adv01, labels, draws) -> (cost, grad w.r.t. adv01); the cost
# already carries the targeted sign (it is ascended); ``draws`` is the step's
# row of the loop's draw table on the piece's device (DI-FGSM's transform,
# TemporalTranslation's random shifts), or None for an attack that draws
# nothing
GradFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                  tuple[torch.Tensor, torch.Tensor]]
# draws(generator) -> (steps, width) int64 rows: a call's random draws, made
# on the host from the call's generator before the loop (DrawTable)
Draws = Callable[[torch.Generator], np.ndarray]


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

    Every chunk gets the step's one row of draws (DI's transform), as the
    JAX engine hands the step's one key to every chunk."""
    if b % chunk:
        chunk = max(d for d in range(1, chunk + 1) if b % d == 0)
    k = b // chunk

    def chunked(adv, labels, draws):
        costs, grads = [], []
        for i in range(k):
            c, g = grad_fn(adv[i * chunk:(i + 1) * chunk], labels[i * chunk:(i + 1) * chunk],
                           draws)
            costs.append(c)
            grads.append(g)
        # global cost = mean of the chunk means; d(global)/d(chunk) =
        # (1/k)·d(chunk mean)/d(chunk)
        return torch.stack(costs).mean(0), torch.cat(grads) / k

    return chunked


def run_sign_attack(grad_fn: GradFn, clean01: torch.Tensor, labels: torch.Tensor,
                    cfg: SignAttackConfig, *,
                    smooth_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                    draws: Optional[Draws] = None,
                    generator: Optional[torch.Generator] = None, graphs: bool = True):
    """Run the iterative sign attack. Returns ``(adv01, per-step costs)``:
    the [0,1]-domain (B, C, T, H, W) adversarial clips and the cost before
    each update stacked over steps, (steps,) or (steps, k) for a vector cost
    such as TAP's, both on ``clean01``'s device. ``draws(generator)`` makes
    the call's random draws, whose row of each step ``grad_fn`` gets."""
    (adv,), costs = run_sign_attack_pieces([grad_fn], [clean01], [labels], cfg,
                                           smooth_fn=smooth_fn, draws=draws,
                                           generator=generator, graphs=graphs)
    return adv, costs


def run_sign_attack_pieces(grad_fns: Sequence[GradFn], clean_pieces: Sequence[torch.Tensor],
                           label_pieces: Sequence[torch.Tensor], cfg: SignAttackConfig, *,
                           smooth_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                           draws: Optional[Draws] = None,
                           generator: Optional[torch.Generator] = None,
                           cost_sum: bool = False, graphs: bool = True):
    """The sign attack over a clip batch held as equal pieces, each on its
    own device with its own ``grad_fn`` (one piece: the one-device attack).
    Returns ``(adv01 pieces, per-step costs)``, the costs on the first
    piece's device.

    With ``cost_sum=False`` each ``grad_fn``'s cost is a mean over its clips:
    the step's cost is the mean of the piece costs and each piece's gradient
    is divided by the piece count, as :func:`_chunked` does. With
    ``cost_sum=True`` each ``grad_fn`` already returns its share of the whole
    batch's cost and gradient (TAP's), and the costs are summed. Every piece
    reads the step's one row of ``draws``. This builds a :class:`SignLoop`
    for the one call; the attacks keep one a batch layout. On a card its
    steps are CUDA graphs (``graphs=False``: eager)."""
    loop = SignLoop(lambda clean: list(grad_fns), clean_pieces, cfg, smooth_fn=smooth_fn,
                    cost_sum=cost_sum, graphs=graphs, draws=draws)
    return loop.run(clean_pieces, label_pieces, generator)


def loop_key(clean_pieces, devices, targeted: int) -> tuple:
    """The key of an attack's :class:`SignLoop` cache: the batch layout."""
    return tuple(devices), tuple(tuple(c.shape) for c in clean_pieces), targeted


class SignLoop:
    """The sign attack's static buffers and steps for one batch layout: each
    piece's clean clips, labels, adversarial clips and momentum, and the
    ``(steps, …)`` costs on the first piece's device, written at a device
    step counter.

    On a card (``graphs``) each piece's step is a CUDA graph on its device:
    the gradient, its scaling and smoothing, the per-piece normalization,
    momentum and the sign step. What crosses pieces runs between the graphs,
    in piece order: the cost reduction, and the whole batch's Σ|g| of the
    ``l1`` normalization, after which each piece's update is a second
    graph.

    ``make_grad_fns(clean pieces)`` builds one ``grad_fn`` a piece over the
    static clean pieces; a ``grad_fn`` with a ``refresh()`` (TAP's, over
    its clean taps) is refreshed when :meth:`run` copies a new batch in.
    With ``draws`` (DI-FGSM's, TemporalTranslation's random shifts),
    :meth:`run` makes the call's draws from its generator and fills each
    piece's :class:`~i2v_tpu_torch.utils.graphs.DrawTable`, and each step
    hands its row to the piece's ``grad_fn``."""

    def __init__(self, make_grad_fns: Callable, clean_pieces: Sequence[torch.Tensor],
                 cfg: SignAttackConfig, *,
                 smooth_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 cost_sum: bool = False, graphs: bool = True, draws: Optional[Draws] = None):
        self.cfg, self.smooth_fn, self.cost_sum, self.draws = cfg, smooth_fn, cost_sum, draws
        self.tables: list = []  # each piece's DrawTable, made at the first run
        self.clean = list(clean_pieces)
        self.n = len(self.clean)
        self.home = self.clean[0].device
        fns = make_grad_fns(self.clean)
        self.refreshers = [r for r in (getattr(fn, "refresh", None) for fn in fns) if r]
        self.fns = [_chunked(fn, c.shape[0], cfg.batch_chunk)
                    if cfg.batch_chunk and cfg.batch_chunk < c.shape[0] else fn
                    for fn, c in zip(fns, self.clean)]
        self.adv = [c.clone() for c in self.clean]
        self.mom = [torch.zeros_like(c) for c in self.clean] if cfg.use_momentum else None
        self.labels = self.records = None
        self.k = torch.zeros(1, dtype=torch.long, device=self.home)
        self.cost_on: list = [None] * self.n  # each piece's cost of the step (n > 1)
        # the whole-batch L1 needs every piece's Σ|g| before any update
        self.split = cfg.grad_norm == "l1" and self.n > 1
        if self.split:
            self.g = [torch.empty_like(c) for c in self.clean]
            self.l1 = [torch.zeros((), device=c.device) for c in self.clean]
            self.total = [torch.zeros((), device=c.device) for c in self.clean]
        self.grad_graphs = [StepGraph(functools.partial(self._grad_step, i), c.device,
                                      enabled=graphs) for i, c in enumerate(self.clean)]
        self.update_graphs = [StepGraph(functools.partial(self._update_step, i), c.device,
                                        enabled=graphs)
                              for i, c in enumerate(self.clean)] if self.split else []

    def _record(self, cost: torch.Tensor) -> None:
        if self.records is None:  # step 0 is eager: made outside any capture
            self.records = torch.empty((self.cfg.steps,) + tuple(cost.shape), dtype=cost.dtype,
                                       device=cost.device)
        self.records.index_copy_(0, self.k, cost.detach().unsqueeze(0))
        self.k.add_(1)

    def _grad_step(self, i: int) -> None:
        draws = self.tables[i].row() if self.tables else None
        cost, g = self.fns[i](self.adv[i], self.labels[i], draws)
        with torch.no_grad():
            if self.n > 1 and not self.cost_sum:
                g = g / self.n
            if self.smooth_fn is not None:
                g = self.smooth_fn(g)
            if self.n == 1:
                self._record(cost)
            elif self.cost_on[i] is None:
                self.cost_on[i] = cost.detach().clone()
            else:
                self.cost_on[i].copy_(cost)
            if self.split:
                self.g[i].copy_(g)
                self.l1[i].copy_(torch.sum(torch.abs(g)))
            else:
                self._update(i, _apply_grad_norm(g, self.cfg.grad_norm))

    def _update_step(self, i: int) -> None:
        with torch.no_grad():
            self._update(i, grad_ops.l1_normalize(self.g[i], self.total[i]))

    def _update(self, i: int, g: torch.Tensor) -> None:
        if self.cfg.use_momentum:
            g = g + self.mom[i] * self.cfg.decay
            self.mom[i].copy_(g)
        self.adv[i].copy_(kernels.sign_step_project(self.adv[i], g, self.clean[i], self.cfg.alpha,
                                                    self.cfg.epsilon))

    def step(self) -> None:
        from ..parallel.mesh import move

        for graph in self.grad_graphs:
            graph()
        with torch.no_grad():
            if self.split:
                total = torch.stack([move(s, self.home) for s in self.l1]).sum()
                for t in self.total:
                    t.copy_(total)
        for graph in self.update_graphs:
            graph()
        if self.n > 1:
            with torch.no_grad():
                self._record(_reduce_costs(self.cost_on, self.home, self.cost_sum))

    def run(self, clean_pieces: Sequence[torch.Tensor], label_pieces: Sequence[torch.Tensor],
            generator: Optional[torch.Generator] = None):
        """→ (adv01 pieces, per-step costs) of a batch of this layout; the
        call's draws, where the loop has ``draws``, from ``generator``."""
        if any(held is not c for held, c in zip(self.clean, clean_pieces)):
            for held, c in zip(self.clean, clean_pieces):
                held.copy_(c)
            for refresh in self.refreshers:
                refresh()
        if self.labels is None:
            self.labels = [lab.clone() for lab in label_pieces]
        else:
            for held, lab in zip(self.labels, label_pieces):
                held.copy_(lab)
        for a, c in zip(self.adv, self.clean):
            a.copy_(c)
        for m in self.mom or ():
            m.zero_()
        self.k.zero_()
        if self.draws is not None:
            rows = self.draws(generator)
            if not self.tables:
                self.tables = [DrawTable(rows, c.device) for c in self.clean]
            for table in self.tables:
                table.fill(rows)
        for _ in range(self.cfg.steps):
            self.step()
        return [a.clone() for a in self.adv], self.records.clone()


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

    def grad_fn(adv01, labels, draws):
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
        and TT randomness every batch). On the CPU, so that drawing a call's
        table never waits on the card."""
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
