"""Build the hand-written CUDA kernels at first use.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with :mod:`ctypes`. The output lands in
``i2v_tpu_torch/_build/`` (git-ignored) under a name that carries a hash of
the source and the flags, so an edited source never loads a stale library.
The library is written under a temporary name and moved into place with
``os.replace``: a concurrent or interrupted build never leaves a truncated
file behind. A failed ``nvcc`` raises with its output; nothing falls back.

Nothing here runs at import time, and nothing here needs a card until a
kernel is launched: the CPU tests import this module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC_DIR), "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class BuiltLibrary:
    """A compiled kernel library: its path, the compiler's log (``-Xptxas -v``
    prints each kernel's registers and spills) and the build seconds (0 when
    the library was already built)."""

    def __init__(self, path: str, log: str, seconds: float):
        self.path = path
        self.log = log
        self.seconds = seconds
        self.cdll = ctypes.CDLL(path)


def build(name: str) -> BuiltLibrary:
    """Compile ``csrc/{name}.cu`` unless the library for its current content
    exists, and load it."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return BuiltLibrary(out, "", 0.0)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    t0 = time.time()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    seconds = time.time() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return BuiltLibrary(out, proc.stdout + proc.stderr, seconds)
