"""Model bundles: a backbone plus the ordered tap keys it exposes.

PyTorch counterparts of :class:`i2v_tpu.models.api.ImageModel` and
:class:`i2v_tpu.models.api.VideoModel`. The module holds its own weights.
Image bundles take NCHW frames ``(N, C, H, W)`` in the [0,1] domain; video
bundles take clips ``(B, C, T, H, W)``, the artifact-protocol layout.
Both expose their module's compute dtype (``dtype``), which the runner reads
to size its frame chunks, as the JAX runner reads ``m.module.dtype``.
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

    @property
    def dtype(self) -> torch.dtype:
        return getattr(self.module, "dtype", torch.float32)

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


@dataclasses.dataclass
class VideoModel:
    """A video backbone and the ordered tap keys it exposes. ``module`` maps a
    clip to (logits, taps dict); ``relu_grad_scale`` is handed to its
    forward (SGM), so that a rescaled bundle shares the weights."""

    name: str
    module: nn.Module
    tap_keys: tuple = ()
    relu_grad_scale: float = 1.0

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return getattr(self.module, "dtype", torch.float32)

    def _run(self, clip, normalize: bool):
        return self.module(clip, normalize=normalize, relu_grad_scale=self.relu_grad_scale)

    def _logits(self, clip, normalize: bool) -> torch.Tensor:
        logits = self._run(clip, normalize)[0]
        if logits is None:
            raise ValueError(f"bundle {self.name!r} was built truncated (no head → "
                             "logits=None); rebuild with truncate=False")
        return logits

    def apply01(self, clip01_bcthw: torch.Tensor) -> torch.Tensor:
        return self._logits(clip01_bcthw, True)

    def apply01_taps(self, clip01_bcthw: torch.Tensor):
        logits, taps = self._run(clip01_bcthw, True)
        return logits, [taps[k] for k in self.tap_keys]

    def apply_norm(self, clip_norm_bcthw: torch.Tensor) -> torch.Tensor:
        """Forward on an already ImageNet-normalized clip. White-box attacks
        differentiate w.r.t. the normalized input, as the reference does
        (base_attacks.py:284-287)."""
        return self._logits(clip_norm_bcthw, False)

    def apply_norm_taps(self, clip_norm_bcthw: torch.Tensor):
        logits, taps = self._run(clip_norm_bcthw, False)
        return logits, [taps[k] for k in self.tap_keys]

    def with_relu_grad_scale(self, scale: float) -> "VideoModel":
        """SGM: the same weights, every non-stem ReLU gradient scaled by
        ``scale`` (reference: base_attacks.py:495-511)."""
        return dataclasses.replace(self, relu_grad_scale=scale)

    def with_taps(self, tap_keys) -> "VideoModel":
        return dataclasses.replace(self, tap_keys=tuple(tap_keys))
