"""Video and image decode dispatch.

PyTorch-side counterpart of :mod:`i2v_tpu.data.decode`, in its order:

  0. a ``.npy``/``.npz`` path is a sidecar of pre-decoded (T,H,W,C) uint8
     frames and is read directly
  1. the native FFmpeg/libjpeg library (:mod:`.native`, built from
     ``native/i2vio.cc``)
  2. ``decord``, where it is installed
  3. the ``path + ".npy"`` sidecar beside the video

Frames come back as uint8 (T, H, W, 3) RGB, scaled to (height, width) where
the backend scales at decode (reference decord usage: datasets.py:204-205).
:func:`backend` names the backend that serves a video path here.
"""

from __future__ import annotations

import os

import numpy as np

from . import native


def _try_native():
    return native if native.available() else None


def _decord():
    try:
        import decord
    except ImportError:
        return None
    return decord


def backend() -> str:
    """'native', 'decord' or 'sidecar': what decodes a video file on this
    machine (a ``.npy``/``.npz`` path is always read as a sidecar)."""
    if _try_native() is not None:
        return "native"
    return "decord" if _decord() is not None else "sidecar"


def decode_video(path: str, width: int = 340, height: int = 256) -> np.ndarray:
    if path.endswith((".npy", ".npz")):
        return _load_sidecar(path)
    sidecar = path + ".npy"
    nat = _try_native()
    if nat is not None:
        return nat.decode_video(path, width=width, height=height)
    decord = _decord()
    if decord is not None:
        try:
            vr = decord.VideoReader(path, width=width, height=height, num_threads=1)
            return vr.get_batch(range(len(vr))).asnumpy()
        except Exception:  # decord raises its own error types
            # a corrupt file is recoverable where a pre-decoded sidecar exists
            pass
    if os.path.exists(sidecar):
        return _load_sidecar(sidecar)
    raise RuntimeError(
        f"no video decode backend for {path!r}: install FFmpeg and libjpeg with their "
        "headers (the native library builds from native/i2vio.cc at first use), install "
        f"decord, or provide a pre-decoded {sidecar!r} sidecar")


def _load_sidecar(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        with np.load(path) as z:
            arr = z[list(z.keys())[0]]
    else:
        arr = np.load(path)
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"sidecar {path!r} must be (T,H,W,3) uint8, got {arr.shape}")
    return arr


def decode_jpeg(path: str) -> np.ndarray:
    """One JPEG as uint8 (H,W,3) RGB: the native libjpeg path where it is
    available, Pillow otherwise (the accimage/PIL dual of the reference,
    dataset_ucf101.py:13-34)."""
    nat = _try_native()
    if nat is not None:
        arr = nat.decode_jpeg(path)
        if arr is not None:
            return arr
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"cannot decode {path!r}: the native library is not built and "
                          "Pillow is not installed") from e
    with open(path, "rb") as f:
        with Image.open(f) as img:
            return np.asarray(img.convert("RGB"))
