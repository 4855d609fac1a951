"""Model bundles: a backbone plus the ordered tap keys it exposes.

PyTorch counterpart of :class:`i2v_tpu.models.api.ImageModel`. The module
holds its own weights; frames are NCHW ``(N, C, H, W)`` in the [0,1] domain.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn


@dataclasses.dataclass
class ImageModel:
    """An image backbone and the ordered tap keys it exposes."""

    name: str
    module: nn.Module
    tap_keys: tuple = ()

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def apply01(self, frames01_nchw: torch.Tensor) -> torch.Tensor:
        logits, _ = self.module(frames01_nchw)
        if logits is None:
            raise ValueError(
                f"bundle {self.name!r} was built truncated (no classifier "
                "head → logits=None); rebuild with truncate=False")
        return logits

    def apply01_taps(self, frames01_nchw: torch.Tensor):
        logits, taps = self.module(frames01_nchw)
        return logits, [taps[k] for k in self.tap_keys]
