"""Pixel-domain transforms: the normalize / un-normalize / ε-project sandwich.

PyTorch counterpart of :mod:`i2v_tpu.ops.pixel`. Clips at the artifact
boundary are ``(B, C, T, H, W)`` float32 in the *normalized* domain; inside
the attacks a clip becomes an NCHW frame batch ``(B·T, C, H, W)``.

``rebuild_adv`` and ``sign_step_project`` here are the plain versions of the
hand-written kernels in :mod:`i2v_tpu_torch.ops.kernels`: the CPU path, and
the oracle each kernel must match bit for bit on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ImageNet statistics, used by both torchvision image models and the
# gluoncv Kinetics-400 video models (reference: base_attacks.py:39-40).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _stats(x: torch.Tensor, channel_axis: int):
    return _stats_on(x.dtype, x.device, x.ndim, channel_axis)


@functools.lru_cache(maxsize=None)
def _stats_on(dtype: torch.dtype, device: torch.device, ndim: int, channel_axis: int):
    """The mean and std shaped to broadcast along ``channel_axis``, made once
    a (dtype, device, layout): a tensor built from Python numbers on a card
    is a blocking copy, which would make the host wait for the card at each
    surrogate's forward. Never an inference tensor, so that a graph may
    save it whatever mode first asked for it."""
    shape = [1] * ndim
    shape[channel_axis] = 3
    with torch.inference_mode(False):
        mean = torch.tensor(IMAGENET_MEAN, dtype=dtype).reshape(shape).to(device)
        std = torch.tensor(IMAGENET_STD, dtype=dtype).reshape(shape).to(device)
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


@functools.lru_cache(maxsize=None)
def _u8_norm_lut(device: torch.device) -> torch.Tensor:
    """(3, 256) float32 table on ``device``: ``lut[c, v] = (v/255 − mean_c)/std_c``,
    computed with host numpy arithmetic, the operations of
    ``data.transforms.u8_clip_to_normalized`` in its order. A uint8 pixel
    takes only 256 values a channel, so the host half of ToTensor+Normalize
    tabulates exactly. Cached for each device: ingest runs once a batch, and
    the table would otherwise cross to the device every time."""
    v = np.arange(256, dtype=np.float32) / np.float32(255.0)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return torch.from_numpy((v[None, :] - mean[:, None]) / std[:, None]).to(device)


def ingest_u8_clips(u8_bthwc, device: torch.device | str | None = None) -> torch.Tensor:
    """Device-side ingest: raw uint8 (B,T,H,W,3) clips (numpy or tensor) →
    [0,1] float32 (B,3,T,H,W) on ``device`` (default: the tensor's own).

    The dual of the host's ToTensor+Normalize → upload → ``unnormalize``
    chain (datasets.py:86-93 + base_attacks.py:145-158): the uint8 frames
    cross to the device, a quarter of the float32 bytes, and the result is
    BIT-IDENTICAL to that chain's clean clip, so uint8 ingress changes the
    transport and not the numbers.

    How: the divides run on the host, in :func:`_u8_norm_lut`, because a
    device divide need not round as numpy does (CUDA's true-divide by a
    scalar multiplies by the reciprocal). On the device run only an exact
    gather from the table and the same eager ``x·std + mean`` that
    :func:`unnormalize` runs on the float32 path, as two separate ops (a
    fused multiply-add would round once where the float32 path rounds
    twice). The uint8 tensor is transposed to (B,3,T,H,W) before anything
    is widened, and the gather runs a channel at a time, so that its int32
    indices cover one channel of the batch (103 MB at B=16), not all three.
    """
    u8 = u8_bthwc if isinstance(u8_bthwc, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(u8_bthwc))
    device = torch.device(device) if device is not None else u8.device
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    u8 = u8.to(device).permute(0, 4, 1, 2, 3)
    lut = _u8_norm_lut(device)
    norm = torch.empty(u8.shape, dtype=torch.float32, device=device)
    for c in range(3):
        idx = u8[:, c].reshape(-1).to(torch.int32)
        norm[:, c] = lut[c].index_select(0, idx).view(norm.shape[0], *norm.shape[2:])
        del idx
    return unnormalize(norm, channel_axis=1)


def is_u8_clips(videos) -> bool:
    """True for the raw uint8 (B,T,H,W,3) ingest layout, as against the
    normalized float32 (B,C,T,H,W) contract: a normalized clip is never
    uint8."""
    dtype = getattr(videos, "dtype", None)
    return (dtype in (np.uint8, torch.uint8) and videos.ndim == 5
            and videos.shape[-1] == 3)


def flatten_clip_to_frames(clip_bcthw: torch.Tensor) -> torch.Tensor:
    """(B,C,T,H,W) → contiguous (B·T, C, H, W) frame batch, the reference's
    ``permute([0,2,1,3,4]).reshape(b*f,c,h,w)`` (image_attacks.py:300-301)."""
    b, c, t, h, w = clip_bcthw.shape
    return clip_bcthw.permute(0, 2, 1, 3, 4).contiguous().view(b * t, c, h, w)


def unflatten_frames_to_clip(frames_nchw: torch.Tensor, batch: int) -> torch.Tensor:
    """(B·T, C, H, W) → (B, C, T, H, W), inverse of flatten_clip_to_frames."""
    bt, c, h, w = frames_nchw.shape
    return frames_nchw.view(batch, bt // batch, c, h, w).permute(0, 2, 1, 3, 4)
