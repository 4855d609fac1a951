"""The one generator of the cells' inputs, from a traffic file's parameters.

Clips are made on the device from the run's seed: uint8 noise at an eighth
of the frame size, repeated into 8×8 blocks (``tools/torch_e2e_400.py``'s
``synth_u8_batch`` does the same on the host), so that the surrogates'
early taps are driven as by real frames; then in [0,1]. Evaluation
artifacts are such clips moved by ±ε noise, clamped to [0,1] and
ImageNet-normalized: ``{label}-adv.npy``, float32 (3, T, H, W), the format
``i2v_tpu_torch.utils.artifacts`` writes by default."""

from __future__ import annotations

import os

import numpy as np
import torch

from . import weights

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# streams of the run's seed: the weights take 0..99
CLIP_STREAM = 1000
ARTIFACT_STREAM = 2000


def clips01(n: int, frames: int, hw: int, seed: int, stream: int, device) -> torch.Tensor:
    """(n, 3, frames, hw, hw) float32 clips in [0,1]."""
    g = weights.generator(seed, stream, device)
    base = torch.randint(0, 256, (n, 3, frames, hw // 8, hw // 8), generator=g, device=device,
                         dtype=torch.uint8)
    full = base.repeat_interleave(8, dim=3).repeat_interleave(8, dim=4)
    return full.to(torch.float32) / 255.0


def normalize(clips: torch.Tensor) -> torch.Tensor:
    shape = (1, 3, 1, 1, 1)
    mean = torch.tensor(MEAN, device=clips.device).reshape(shape)
    std = torch.tensor(STD, device=clips.device).reshape(shape)
    return (clips - mean) / std


def write_artifacts(run_dir: str, n: int, frames: int, hw: int, epsilon: float, seed: int,
                    device, per_call: int = 8) -> list[str]:
    """``n`` artifacts ``{0..n-1}-adv.npy`` under ``run_dir``; → file names."""
    os.makedirs(run_dir, exist_ok=True)
    g = weights.generator(seed, ARTIFACT_STREAM, device)
    names = []
    for start in range(0, n, per_call):
        k = min(per_call, n - start)
        clean = clips01(k, frames, hw, seed, ARTIFACT_STREAM + 1 + start, device)
        sign = torch.randint(0, 2, clean.shape, generator=g, device=device).to(torch.float32)
        adv = normalize(torch.clamp(clean + epsilon * (2 * sign - 1), 0.0, 1.0)).cpu().numpy()
        for i in range(k):
            name = f"{start + i}-adv.npy"
            np.save(os.path.join(run_dir, name), np.ascontiguousarray(adv[i]))
            names.append(name)
    return names
