"""A model bundle on each device of a mesh, and its evaluation forwards.

The JAX package places one set of weights on every device of a mesh with a
replicated sharding. Here a bundle's module lives on one device, and each
other device that runs it holds a deep copy, built at first use and kept:
data-parallel evaluation (:mod:`i2v_tpu_torch.eval.transfer`) and the
white-box attacks over a clip-sharded batch (:mod:`i2v_tpu_torch.attacks.core`)
share this one class.

Evaluation runs each replica's forward, with top-1 and the predictions, as
one step a (device, batch shape, dtype): a CUDA graph on a card, captured at
the second batch of that shape and replayed from then on
(:mod:`i2v_tpu_torch.utils.graphs`), as the JAX package's evaluation is one
jitted forward a batch shape. :func:`replicas_for` keeps one
:class:`Replicas`, with its graphs, on the bundle for each mesh, so that
later evaluations of the bundle neither copy it again nor capture again.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

from ..utils.graphs import StepGraph
from .mesh import Mesh, move

# the static input of each (device, shape, dtype), shared by every model's
# forward: they run one after another on the device's stream
_inputs: dict = {}


def _static_input(device: torch.device, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    key = (device, shape, dtype)
    if key not in _inputs:
        with torch.inference_mode():
            _inputs[key] = torch.empty(shape, dtype=dtype, device=device)
    return _inputs[key]


class _Forward:
    """One bundle's forward of one batch shape on one device: logits, the
    top-1 accuracy and the predictions against static labels, into static
    outputs that the next call of this shape overwrites."""

    def __init__(self, bundle, x: torch.Tensor, graphs: bool):
        self.bundle, self.x = bundle, x
        with torch.inference_mode():
            self.labels = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
        self.logits = self.acc = self.preds = None
        self.graph = StepGraph(self._step, x.device, enabled=graphs)

    @torch.inference_mode()
    def _step(self) -> None:
        from ..eval.transfer import accuracy_and_preds

        logits = self.bundle.apply_norm(self.x)
        acc, preds = accuracy_and_preds(logits, self.labels)
        if self.logits is None:  # step 0 is eager: made outside any capture
            self.logits, self.acc, self.preds = logits, acc, preds
        else:
            self.logits.copy_(logits)
            self.acc.copy_(acc)
            self.preds.copy_(preds)

    @torch.inference_mode()
    def __call__(self, clips: torch.Tensor, labels: Optional[torch.Tensor]) -> "_Forward":
        self.x.copy_(clips)
        if labels is not None:
            self.labels.copy_(labels)
        self.graph()
        return self


class Replicas:
    """``bundle`` on its own device and a copy of it moved to each other
    device asked for (every distinct device of ``mesh``, and any device
    later passed to :meth:`on`), each built once; and the evaluation
    forwards of each replica, one a batch shape (``graphs``: CUDA graphs on
    a card, eager with ``graphs=False``)."""

    def __init__(self, bundle, mesh: Optional[Mesh] = None, *, graphs: bool = True):
        self.bundle = bundle
        self.graphs = graphs
        self.by_device = {bundle.device: bundle}
        self._forwards: dict = {}
        for dev in ([] if mesh is None else mesh.distinct_devices):
            self.on(dev)

    def on(self, device) -> object:
        """The bundle's replica on ``device``."""
        device = torch.device(device)
        if device not in self.by_device:
            self.by_device[device] = dataclasses.replace(
                self.bundle, module=copy.deepcopy(self.bundle.module).to(device))
        return self.by_device[device]

    def _forward(self, device: torch.device, clips: torch.Tensor) -> _Forward:
        key = (device, tuple(clips.shape), clips.dtype)
        if key not in self._forwards:
            self._forwards[key] = _Forward(self.by_device[device],
                                           _static_input(clips.device, *key[1:]), self.graphs)
        return self._forwards[key]

    def predict(self, clips, positions: Optional[list], labels: Optional[torch.Tensor] = None):
        """→ (logits, top-1 %, predictions) of whole clips, or of a batch's
        mesh pieces gathered in clip order on the first device (a piece held
        by several positions of one device, never here: the eval sharding
        cuts over every axis). The accuracy and predictions need
        ``labels``, on the first device. The outputs of whole clips are the
        forward's static buffers: read them before the next batch."""
        from ..eval.transfer import accuracy_and_preds

        if isinstance(clips, torch.Tensor):
            f = self._forward(clips.device, clips)(clips, labels)
            return f.logits, f.acc, f.preds
        home = positions[0]
        with torch.inference_mode():
            logits = torch.cat([move(self._forward(d, c)(c, None).logits.clone(), home)
                                for d, c in zip(positions, clips)])
            if labels is None:
                return logits, None, None
            return (logits,) + accuracy_and_preds(logits, labels)

    def logits(self, clips, positions: Optional[list]) -> torch.Tensor:
        """The bundle's logits of whole clips, or of a batch's mesh pieces
        gathered in clip order on the first device (see :meth:`predict`)."""
        return self.predict(clips, positions)[0]


def replicas_for(bundle, mesh: Optional[Mesh] = None, *, graphs: bool = True) -> Replicas:
    """The :class:`Replicas` of ``bundle`` over ``mesh``, built at the first
    call and held on the bundle with its forwards' graphs."""
    held = bundle.__dict__.setdefault("_replicas", {})
    key = (mesh, graphs)
    if key not in held:
        held[key] = Replicas(bundle, mesh, graphs=graphs)
    return held[key]
