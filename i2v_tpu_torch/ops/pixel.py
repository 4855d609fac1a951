"""Pixel-domain transforms: the normalize / un-normalize / ε-project sandwich.

PyTorch counterpart of :mod:`i2v_tpu.ops.pixel`. Clips at the artifact
boundary are ``(B, C, T, H, W)`` float32 in the *normalized* domain; inside
the attacks a clip becomes an NCHW frame batch ``(B·T, C, H, W)``.

``rebuild_adv`` and ``sign_step_project`` here are the plain versions of the
hand-written kernels in :mod:`i2v_tpu_torch.ops.kernels`: the CPU path, and
the oracle each kernel must match bit for bit on the card.
"""

from __future__ import annotations

import torch

# ImageNet statistics, used by both torchvision image models and the
# gluoncv Kinetics-400 video models (reference: base_attacks.py:39-40).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _stats(x: torch.Tensor, channel_axis: int):
    shape = [1] * x.ndim
    shape[channel_axis] = 3
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device).reshape(shape)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device).reshape(shape)
    return mean, std


def normalize(x: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
    """[0,1] pixel domain → ImageNet-normalized domain."""
    mean, std = _stats(x, channel_axis)
    return (x - mean) / std


def unnormalize(x: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
    """ImageNet-normalized domain → [0,1] pixel domain."""
    mean, std = _stats(x, channel_axis)
    return x * std + mean


def scale_perts(perts: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
    """Normalized-domain perturbation → pixel-domain scale (÷std only): the
    reference's ``_transform_perts`` of TAP's smoothness term
    (base_attacks.py:138-143, 795)."""
    _, std = _stats(perts, channel_axis)
    return perts / std


def project_linf(adv: torch.Tensor, clean: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Project ``adv`` into the ε-ball around ``clean`` ∩ [0,1]
    (reference: base_attacks.py:291-292)."""
    delta = torch.clamp(adv - clean, -epsilon, epsilon)
    return torch.clamp(clean + delta, 0.0, 1.0)


def rebuild_adv(clean01: torch.Tensor, modifier: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Additive-modifier rebuild of the Adam-based image-guided attacks:
    ``clamp(clean + clamp(modifier, ±ε), 0, 1)`` (reference:
    image_attacks.py:331). torch.clamp's autograd passes the gradient on the
    closed interval, as the kernel's backward does."""
    return torch.clamp(clean01 + torch.clamp(modifier, -epsilon, epsilon), 0.0, 1.0)


def sign_keep_nan(g: torch.Tensor) -> torch.Tensor:
    """``sign(g)`` with NaN kept, as ``jnp.sign`` and the Pallas kernel give
    it (``torch.sign(nan)`` is 0, which would skip the pixel without a
    trace)."""
    return torch.where(torch.isnan(g), g, torch.sign(g))


def sign_step_project(adv01: torch.Tensor, grad: torch.Tensor, clean01: torch.Tensor,
                      step_size: float, epsilon: float) -> torch.Tensor:
    """One full sign-attack pixel update: ``adv + α·sign(g)`` then ε-ball and
    [0,1] projection. A NaN gradient gives a NaN pixel (:func:`sign_keep_nan`)."""
    stepped = adv01 + step_size * sign_keep_nan(grad)
    return project_linf(stepped, clean01, epsilon)


def flatten_clip_to_frames(clip_bcthw: torch.Tensor) -> torch.Tensor:
    """(B,C,T,H,W) → contiguous (B·T, C, H, W) frame batch, the reference's
    ``permute([0,2,1,3,4]).reshape(b*f,c,h,w)`` (image_attacks.py:300-301)."""
    b, c, t, h, w = clip_bcthw.shape
    return clip_bcthw.permute(0, 2, 1, 3, 4).contiguous().view(b * t, c, h, w)


def unflatten_frames_to_clip(frames_nchw: torch.Tensor, batch: int) -> torch.Tensor:
    """(B·T, C, H, W) → (B, C, T, H, W), inverse of flatten_clip_to_frames."""
    bt, c, h, w = frames_nchw.shape
    return frames_nchw.view(batch, bt // batch, c, h, w).permute(0, 2, 1, 3, 4)
