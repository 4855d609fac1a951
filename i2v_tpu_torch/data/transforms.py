"""Deterministic clip preprocessing on the host, in numpy.

PyTorch-side counterpart of :mod:`i2v_tpu.data.transforms`, with the same
names and the same bytes out. A frame is a uint8 (H, W, C) array here, where
the JAX package passes PIL images:

  - Kinetics: Resize(short side, bilinear) → CenterCrop(224) → [0,1] CHW →
    ImageNet Normalize (reference: datasets.py:86-93)
  - UCF-101: Scale(224) → CornerCrop(224,'c') → ToTensor → Normalize with
    LoopPadding(32) (reference: dataset_ucf101.py:113-126)
  - temporal crops, including the reference's frozen-seed "random" variants
    (transforms_ucf101.py:117-128: every randomize call reseeds to 1024,
    so the preprocessing is deterministic)

Pillow is imported only where a frame is really resized. The Kinetics path
needs none: decode already scales to 340×256 (``decode.decode_video``), so
the resize to a 256 short side returns the frame untouched and the centre
crop is a numpy slice with PIL's rounding. Without Pillow, a resize raises;
no other resize stands in for PIL's bilinear filter.

Outputs are float32 (C, T, H, W) normalized clips, the attack and eval
contract, or their uint8 (T, H, W, C) spatial half.
"""

from __future__ import annotations

import random
from typing import Sequence

import numpy as np

from ..ops.pixel import IMAGENET_MEAN, IMAGENET_STD

_FROZEN_SEED = 1024  # reference: transforms_ucf101.py:117 et al.


def _pil():
    """Pillow's ``Image`` module, for the calls that resize."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("this transform resizes frames with Pillow's bilinear filter, "
                          "and Pillow is not installed; the Kinetics path at the decode "
                          "size (short side 256) needs no resize") from e
    return Image


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    Image = _pil()
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


def _crop(img: np.ndarray, box) -> np.ndarray:
    """PIL's ``Image.crop``: the box's corners are rounded, and the parts of
    the box outside the frame are zeros."""
    x1, y1, x2, y2 = (int(round(v)) for v in box)
    h, w = img.shape[:2]
    if 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h:
        return img[y1:y2, x1:x2]
    out = np.zeros((y2 - y1, x2 - x1) + img.shape[2:], img.dtype)
    sx1, sy1, sx2, sy2 = max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)
    if sx1 < sx2 and sy1 < sy2:
        out[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = img[sy1:sy2, sx1:sx2]
    return out


# ---------------------------------------------------------------------------
# spatial
# ---------------------------------------------------------------------------

def _keeps_size(w: int, h: int, size: int) -> bool:
    return (w <= h and w == size) or (h <= w and h == size)


def resize_short_side(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the SHORT side equals ``size``, bilinear; a frame whose
    short side is ``size`` already comes back as it is."""
    h, w = img.shape[:2]
    if _keeps_size(w, h, size):
        return img
    if w < h:
        return _resize(img, size, int(size * h / w))
    return _resize(img, int(size * w / h), size)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    x1 = int(round((w - size) / 2.0))
    y1 = int(round((h - size) / 2.0))
    return _crop(img, (x1, y1, x1 + size, y1 + size))


# CornerCrop(size, 'c'), the centre corner (transforms_ucf101.py:345-346), is
# arithmetically the centre crop (both round the margin split)
corner_crop_center = center_crop


def frames_to_normalized_clip(frames: Sequence[np.ndarray]) -> np.ndarray:
    """List of uint8 (H,W,C) frames → normalized float32 (C, T, H, W)."""
    return u8_clip_to_normalized(np.stack([np.asarray(f, dtype=np.uint8) for f in frames]))


def u8_clip_to_normalized(u8_thwc: np.ndarray) -> np.ndarray:
    """uint8 (T,H,W,C) → normalized float32 (C,T,H,W), the host half of
    ToTensor+Normalize. Its device twin is ``ops.pixel.ingest_u8_clips``,
    whose table holds these same float32 operations in this order."""
    arr = u8_thwc.astype(np.float32)
    arr /= 255.0
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    arr = (arr - mean) / std
    return np.transpose(arr, (3, 0, 1, 2))  # CTHW


def kinetics_val_frames_u8(frames_thwc: np.ndarray, short_side: int = 256,
                           crop: int = 224) -> np.ndarray:
    """The spatial half of the Kinetics validation pipeline: decoded uint8
    (T,H,W,C) → resized and cropped uint8 (T,crop,crop,C). Normalization runs
    on the host (``u8_clip_to_normalized``) or on the device
    (``ops.pixel.ingest_u8_clips``), by ingest mode."""
    h, w = frames_thwc.shape[1:3]
    if _keeps_size(w, h, short_side):
        # the decode size: one crop of the whole stack, no Pillow
        return np.ascontiguousarray(center_crop(frames_thwc.transpose(1, 2, 0, 3), crop)
                                    .transpose(2, 0, 1, 3))
    return np.stack([center_crop(resize_short_side(f, short_side), crop)
                     for f in frames_thwc])


def kinetics_val_transform(frames_thwc: np.ndarray, short_side: int = 256,
                           crop: int = 224) -> np.ndarray:
    """The Kinetics validation pipeline on a decoded uint8 (T,H,W,C) buffer."""
    return u8_clip_to_normalized(kinetics_val_frames_u8(frames_thwc, short_side, crop))


def ucf_test_frames_u8(frames: Sequence[np.ndarray], size: int = 224) -> np.ndarray:
    """The spatial half of the UCF-101 eval pipeline → uint8 (T,size,size,C)."""
    return np.stack([corner_crop_center(resize_short_side(f, size), size) for f in frames])


def ucf_test_transform(frames: Sequence[np.ndarray], size: int = 224) -> np.ndarray:
    """The UCF-101 eval pipeline on decoded uint8 (H,W,C) frames."""
    return u8_clip_to_normalized(ucf_test_frames_u8(frames, size))


# ---------------------------------------------------------------------------
# temporal
# ---------------------------------------------------------------------------

def _cycle_pad(out: list[int], size: int) -> list[int]:
    """Cycle-pad like the reference's self-growing ``for index in out`` loop
    (the appended tail re-enters the iteration, so out[k] = out[k % len0])."""
    i = 0
    while out and len(out) < size:
        out.append(out[i])
        i += 1
    return out


def loop_padding(frame_indices: list[int], size: int) -> list[int]:
    """LoopPadding (transforms_ucf101.py:23-39). The reference slices
    ``frame_indices[1:size+1]``: it SKIPS the first entry, so with 1-based
    frame indices [1..duration] the clip starts at image_00002."""
    return _cycle_pad(list(frame_indices[1:size + 1]), size)


def temporal_begin_crop(frame_indices: list[int], size: int) -> list[int]:
    """TemporalBeginCrop, the same [1:size+1] slice as LoopPadding
    (transforms_ucf101.py:42-61)."""
    return _cycle_pad(list(frame_indices[1:size + 1]), size)


def temporal_center_crop(frame_indices: list[int], size: int) -> list[int]:
    """TemporalCenterCrop: begin clamps to 1, not 0 (transforms_ucf101.py:84-94)."""
    center = len(frame_indices) // 2
    begin = max(1, center - size // 2)
    end = min(begin + size, len(frame_indices))
    return _cycle_pad(list(frame_indices[begin:end]), size)


def temporal_random_crop(frame_indices: list[int], size: int) -> list[int]:
    """'Random' begin crop with the reference's frozen seed: deterministic by
    construction; rand_end clamps to 1 (transforms_ucf101.py:115-128)."""
    rand_end = max(1, len(frame_indices) - size - 1)
    random.seed(_FROZEN_SEED)
    begin = random.randint(0, rand_end)
    end = min(begin + size, len(frame_indices))
    return _cycle_pad(list(frame_indices[begin:end]), size)


def random_horizontal_flip(img: np.ndarray) -> np.ndarray:
    """RandomHorizontalFlip with the reference's frozen seed: p < 0.5 drawn
    from a freshly reseeded stream is constant, so this never flips; kept for
    the transform set's sake, quirk and all."""
    random.seed(_FROZEN_SEED)
    if random.random() < 0.5:
        return img[:, ::-1]
    return img


_MULTISCALE_POSITIONS = ("c", "tl", "tr", "bl", "br")


def multiscale_corner_crop(img: np.ndarray, size: int, scales=(1.0, 0.8)) -> np.ndarray:
    """MultiScaleCornerCrop (transforms_ucf101.py:401-469). The reference
    RESEEDS to 1024 before EACH draw, so scale and position both take the
    stream's first value (scale index 0, position 'c'); its 'c' box is
    centre ± crop//2 (an even-sized box), not CornerCrop's rounded split."""
    random.seed(_FROZEN_SEED)
    scale = scales[random.randint(0, len(scales) - 1)]
    random.seed(_FROZEN_SEED)
    position = _MULTISCALE_POSITIONS[random.randint(0, len(_MULTISCALE_POSITIONS) - 1)]
    h, w = img.shape[:2]
    crop = int(min(w, h) * scale)
    if position == "c":
        cx, cy, half = w // 2, h // 2, crop // 2
        box = (cx - half, cy - half, cx + half, cy + half)
    elif position == "tl":
        box = (0, 0, crop, crop)
    elif position == "tr":
        box = (w - crop, 0, w, crop)
    elif position == "bl":
        box = (0, h - crop, crop, h)
    else:  # br
        box = (w - crop, h - crop, w, h)
    return _resize(np.ascontiguousarray(_crop(img, box)), size, size)


def multiscale_random_crop(img: np.ndarray, size: int, scales=(1.0, 0.8)) -> np.ndarray:
    """MultiScaleRandomCrop (transforms_ucf101.py:471-503). The reference
    reseeds before tl_x and again before tl_y, so tl_x == tl_y always, but
    draws the scale from the ambient random state; the scale draw is reseeded
    here too, as in the JAX package, so that the output depends on nothing
    the caller did with the global stream."""
    random.seed(_FROZEN_SEED)
    scale = scales[random.randint(0, len(scales) - 1)]
    random.seed(_FROZEN_SEED)
    tl_x = random.random()
    random.seed(_FROZEN_SEED)
    tl_y = random.random()
    h, w = img.shape[:2]
    crop = int(min(w, h) * scale)
    x1 = tl_x * (w - crop)
    y1 = tl_y * (h - crop)
    return _resize(np.ascontiguousarray(_crop(img, (x1, y1, x1 + crop, y1 + crop))),
                   size, size)


def kinetics_clip_indices(n_frames: int, clip_ind: int, clip_len: int = 32,
                          frame_sample_rate: int = 2,
                          num_segment: int = 1) -> np.ndarray:
    """Deterministic frame-index selection seeded by the manifest's
    clip_index (reference: datasets.py:218-241). clip_ind == -1 anchors the
    window at the segment end."""
    converted_len = int(clip_len * frame_sample_rate)
    seg_len = n_frames // num_segment
    all_index = []
    # one random stream across segments (the reference seeds once and draws
    # in turn, datasets.py:230-241)
    rng = np.random.RandomState(clip_ind) if clip_ind != -1 else None
    for i in range(num_segment):
        if seg_len <= converted_len:
            index = np.linspace(0, seg_len, num=seg_len // frame_sample_rate)
            index = np.concatenate(
                (index, np.ones(clip_len - seg_len // frame_sample_rate) * seg_len))
            index = np.clip(index, 0, seg_len - 1).astype(np.int64)
        else:
            end_idx = seg_len - 1 if rng is None else rng.randint(converted_len, seg_len)
            str_idx = end_idx - converted_len
            index = np.linspace(str_idx, end_idx, num=clip_len)
            index = np.clip(index, str_idx, end_idx - 1).astype(np.int64)
        all_index.extend(list(index + i * seg_len))
    return np.asarray(all_index, dtype=np.int64)
