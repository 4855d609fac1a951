"""A model bundle on each device of a mesh.

The JAX package places one set of weights on every device of a mesh with a
replicated sharding. Here a bundle's module lives on one device, and each
other device that runs it holds a deep copy, built at first use and kept:
data-parallel evaluation (:mod:`i2v_tpu_torch.eval.transfer`) and the
white-box attacks over a clip-sharded batch (:mod:`i2v_tpu_torch.attacks.core`)
share this one class.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from .mesh import Mesh, move


class Replicas:
    """``bundle`` on its own device and a deep copy of it moved to each
    other device asked for (every distinct device of ``mesh``, and any
    device later passed to :meth:`on`), each built once."""

    def __init__(self, bundle, mesh: Optional[Mesh] = None):
        self.bundle = bundle
        self.by_device = {bundle.device: bundle}
        for dev in ([] if mesh is None else mesh.distinct_devices):
            self.on(dev)

    def on(self, device) -> object:
        """The bundle's replica on ``device``."""
        device = torch.device(device)
        if device not in self.by_device:
            replica = copy.deepcopy(self.bundle)
            replica.module.to(device)
            self.by_device[device] = replica
        return self.by_device[device]

    def logits(self, clips, positions: Optional[list]) -> torch.Tensor:
        """The bundle's logits of whole clips, or of a batch's mesh pieces
        gathered in clip order on the first device (a piece held by several
        positions of one device, never here: the eval sharding cuts over
        every axis)."""
        if isinstance(clips, torch.Tensor):
            return self.by_device[clips.device].apply_norm(clips)
        home = positions[0]
        return torch.cat([move(self.by_device[d].apply_norm(c), home)
                          for d, c in zip(positions, clips)])
