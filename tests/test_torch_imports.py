"""The port stands alone: every module of ``i2v_tpu_torch`` imports with JAX,
Flax, Optax and the JAX package made unimportable."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "i2v_tpu"):
    sys.modules[name] = None
import i2v_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(i2v_tpu_torch.__path__, "i2v_tpu_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "i2v_tpu")
                and sys.modules[k] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20
