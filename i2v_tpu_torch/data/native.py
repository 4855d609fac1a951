"""ctypes bindings for the native FFmpeg/libjpeg decode runtime.

PyTorch-side counterpart of :mod:`i2v_tpu.data.native`. The library is built
from the repository's ``native/i2vio.cc`` at first use, with ``g++``, into
``i2v_tpu_torch/_build/`` (git-ignored) under a name that carries a hash of
the source and the command, written under a temporary name and moved into
place with ``os.replace``. It needs FFmpeg's and libjpeg's headers and
libraries; where they are missing the build fails, its compiler output is
logged, and :func:`available` is false, so that decode falls through to the
next backend (``decode.py``). ``I2V_TPU_NATIVE_LIB`` names a prebuilt library
instead; a missing file there is not replaced by a fresh build.

Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
from typing import Optional

import numpy as np

_log = logging.getLogger(__name__)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "i2vio.cc")
BUILD_DIR = os.path.join(_ROOT, "i2v_tpu_torch", "_build")
_CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-pthread")
_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-ljpeg")

_u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
_intp = ctypes.POINTER(ctypes.c_int)


def _build() -> Optional[str]:
    """Compile ``native/i2vio.cc`` unless the library for its current content
    exists; the library's path, or None (logged) if the build failed."""
    try:
        with open(SOURCE, "rb") as f:
            source = f.read()
    except OSError as e:
        _log.warning("native decode library not built: %s", e)
        return None
    digest = hashlib.sha256(source + " ".join(_CXX_FLAGS + _LIBS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"libi2vio-{digest[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    try:
        proc = subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, SOURCE, *_LIBS],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        _log.warning("native decode library not built (%s): %s", SOURCE, e)
        return None
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        tail = "\n".join((proc.stdout + proc.stderr).strip().splitlines()[-8:])
        _log.warning("native decode library not built: g++ exited %d on %s:\n%s",
                     proc.returncode, SOURCE, tail)
        return None
    os.replace(tmp, out)
    return out


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    """The loaded library with its signatures declared, or None. Its
    ``has_batch`` attribute says whether the batch entry points exist (a
    prebuilt library from before them lacks them)."""
    override = os.environ.get("I2V_TPU_NATIVE_LIB")
    path = override if override else _build()
    if path is None or not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.i2v_decode_video.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                         _u8pp, _intp]
        lib.i2v_decode_video.restype = ctypes.c_int
        lib.i2v_decode_jpeg.argtypes = [ctypes.c_char_p, _u8pp, _intp, _intp]
        lib.i2v_decode_jpeg.restype = ctypes.c_int
        lib.i2v_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.i2v_free.restype = None
    except (OSError, AttributeError) as e:
        # a stale or partial library without the core symbols: no native backend
        _log.warning("native decode library %s not usable: %s", path, e)
        return None
    try:
        lib.i2v_decode_videos.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          _u8pp, _intp, _intp]
        lib.i2v_decode_videos.restype = ctypes.c_int
        lib.i2v_decode_jpegs.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                         ctypes.c_int, _u8pp, _intp, _intp, _intp]
        lib.i2v_decode_jpegs.restype = ctypes.c_int
        lib.has_batch = True
    except AttributeError:
        lib.has_batch = False
    return lib


def available() -> bool:
    return _load() is not None


def _take(lib, ptr, shape) -> np.ndarray:
    """Copy a buffer the library allocated into numpy and free it."""
    try:
        size = int(np.prod(shape))
        return np.ctypeslib.as_array(ptr, shape=(size,)).reshape(shape).copy()
    finally:
        lib.i2v_free(ptr)


def _maybe(fn, *args):
    try:
        return fn(*args)
    except RuntimeError:
        return None


def decode_video(path: str, width: int = 340, height: int = 256) -> np.ndarray:
    """Every frame of a video, scaled to (height, width): uint8 (T,H,W,3)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int(0)
    rc = lib.i2v_decode_video(path.encode(), width, height, ctypes.byref(out),
                              ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"i2v_decode_video({path!r}) failed with code {rc}")
    return _take(lib, out, (n.value, height, width, 3))


def decode_videos(paths: list, width: int = 340, height: int = 256,
                  threads: int = 0) -> list:
    """Decode a batch of videos on the native thread pool (one call that
    holds no interpreter lock). Per-path (T,H,W,3) uint8 arrays, None where
    decode failed."""
    lib = _load()
    n = len(paths)
    if n == 0:
        return []
    if not lib.has_batch:
        return [_maybe(decode_video, p, width, height) for p in paths]
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    n_frames = (ctypes.c_int * n)()
    rcs = (ctypes.c_int * n)()
    lib.i2v_decode_videos(c_paths, n, width, height, threads, outs, n_frames, rcs)
    return [None if rcs[i] != 0 or not outs[i]
            else _take(lib, outs[i], (n_frames[i], height, width, 3)) for i in range(n)]


def decode_jpegs(paths: list, threads: int = 0) -> list:
    """Decode a batch of JPEGs on the native thread pool. Per-path (H,W,3)
    uint8 arrays, None where decode failed."""
    lib = _load()
    n = len(paths)
    if n == 0:
        return []
    if not lib.has_batch:
        return [decode_jpeg(p) for p in paths]
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    ws = (ctypes.c_int * n)()
    hs = (ctypes.c_int * n)()
    rcs = (ctypes.c_int * n)()
    lib.i2v_decode_jpegs(c_paths, n, threads, outs, ws, hs, rcs)
    return [None if rcs[i] != 0 or not outs[i] else _take(lib, outs[i], (hs[i], ws[i], 3))
            for i in range(n)]


def decode_jpeg(path: str) -> Optional[np.ndarray]:
    """One JPEG as uint8 (H,W,3), or None if decode failed."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.i2v_decode_jpeg(path.encode(), ctypes.byref(out), ctypes.byref(w),
                             ctypes.byref(h))
    if rc != 0:
        return None
    return _take(lib, out, (h.value, w.value, 3))
