"""Attack base: the reference-compatible calling convention.

PyTorch counterpart of :class:`i2v_tpu.attacks.core.Attack`. Attacks are
callables that take a *normalized-domain* clip batch ``(B, C, T, H, W)`` and
labels and return the normalized adversarial batch (base_attacks.py:226-234);
inside, everything runs in the [0,1] pixel domain. Per-step costs land in
``self.loss_info``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops import pixel


class Attack:
    """Subclasses implement ``_attack01(clean01, labels) -> (adv01, costs)``
    on tensors on ``self.device``."""

    def __init__(self, name: str, model: Any = None, device: torch.device | str = "cpu"):
        self.attack = name
        self.model = model
        self.device = torch.device(device)
        self._attack_mode = "default"
        self._return_type = "float"
        self.loss_info: dict = {}

    def set_return_type(self, type: str) -> None:
        """'float' (normalized clips) or 'int' (uint8 [0,255] pixel clips)
        (reference: base_attacks.py:82-93)."""
        if type not in ("float", "int"):
            raise ValueError(f"{type} is not a valid type. [Options: float, int]")
        self._return_type = type

    def _attack01(self, clean01, labels):
        raise NotImplementedError

    def __call__(self, videos, labels, video_names=None) -> torch.Tensor:
        if not isinstance(videos, torch.Tensor):
            videos = torch.from_numpy(np.array(videos, dtype=np.float32))
        clean01 = pixel.unnormalize(videos.to(self.device, torch.float32), channel_axis=1)
        adv01, costs = self._attack01(clean01, labels)
        self._record_costs(costs, video_names)
        if self._return_type == "int":
            return (adv01 * 255).to(torch.uint8)
        return pixel.normalize(adv01, channel_axis=1)

    def _record_costs(self, costs, video_names) -> None:
        if video_names is None or costs is None:
            return
        costs = np.asarray(costs)
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
