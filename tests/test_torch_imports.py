"""The port stands alone: every module of ``i2v_tpu_torch`` (the multi-device
``parallel.mesh``, ``parallel.ensemble`` and ``parallel.dist`` among them),
and the port's tools ``tools/torch_asr_proxy.py``,
``tools/torch_mesh_profile.py``, ``tools/torch_convert_torchvision.py``,
``tools/torch_convert_gluoncv.py`` and ``tools/torch_gluoncv_fakes.py``,
and the measurement tools ``tools/torch_e2e_400.py``,
``tools/torch_perf_probe.py`` and ``tools/torch_baseline_anchor.py``,
import with JAX, Flax, Optax and the JAX package made unimportable, and with
pandas, msgpack and Pillow too (a machine with a card need not have them);
the converters convert and write their files there. Imported where nothing
is blocked, the measurement tools load none of JAX, Flax or the JAX
package."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from tests.torch_threads import torch_rng_restored  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "i2v_tpu", "pandas", "msgpack", "PIL")
for name in BLOCKED:
    sys.modules[name] = None
import i2v_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(i2v_tpu_torch.__path__, "i2v_tpu_torch."))
assert {"i2v_tpu_torch.parallel." + m for m in ("mesh", "ensemble", "dist")} <= set(names)
for name in names:
    importlib.import_module(name)
import tools.torch_asr_proxy
import tools.torch_mesh_profile
import tools.torch_convert_torchvision
import tools.torch_convert_gluoncv as gluoncv
import tools.torch_gluoncv_fakes as fakes
import tools.torch_e2e_400
import tools.torch_perf_probe
import tools.torch_baseline_anchor
import os, tempfile
from i2v_tpu_torch.models import convert
fake = fakes.I3DResNet((1, 1, 1, 1), ((1,), (1,), (1,), (0,)), ((), (0,), (), ()), width=8,
                       num_classes=10)
with tempfile.TemporaryDirectory() as d:
    convert.save_params(gluoncv.convert_i3d(fake.state_dict(), (1, 1, 1, 1)), "i3d", d)
    import tools.torch_surrogates
    sd = tools.torch_surrogates.squeezenet1_1().state_dict()
    convert.convert_torchvision("squeezenet", sd, d)
    assert sorted(os.listdir(d)) == ["i3d.msgpack", "squeezenet.msgpack"]
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in BLOCKED and sys.modules[k] is not None)
assert not leaked, leaked
# the card's Kinetics path runs without them: the manifest, a checkpoint,
# the crop at the decode size
import os, numpy as np
from i2v_tpu_torch.data import kinetics, transforms
from i2v_tpu_torch.models import checkpoint
from i2v_tpu_torch.utils import paths
rows = kinetics.read_manifest(os.path.join(paths.MANIFEST_DIR, "kinetics400_attack_samples.csv"))
assert len(rows) == 400
tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
assert (checkpoint.restore(checkpoint.serialize(tree))["params"]["w"] == tree["params"]["w"]).all()
assert transforms.kinetics_val_frames_u8(np.zeros((1, 256, 340, 3), np.uint8)).shape == (1, 224, 224, 3)
print(len(names))
"""


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


_TOOLS = """
import sys
import tools.torch_e2e_400, tools.torch_perf_probe, tools.torch_baseline_anchor
loaded = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "i2v_tpu"))
assert not loaded, loaded
print("ok")
"""


def test_the_measurement_tools_load_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _TOOLS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def _imported_roots(path: str) -> set:
    """The top-level names of every module a Python file imports, at any
    depth of its code (function-level imports included)."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_and_every_port_file_name_no_jax_module():
    """``chip_smoke.py`` and every file of ``i2v_tpu_torch`` import nothing
    of JAX, Flax, Optax or the JAX package, not even inside a function
    (which the import test above does not run)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "i2v_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    banned = {"jax", "jaxlib", "flax", "optax", "i2v_tpu"}
    leaks = {os.path.relpath(f, REPO): sorted(_imported_roots(f) & banned) for f in files}
    assert not {f: r for f, r in leaks.items() if r}
