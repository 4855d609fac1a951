"""Nothing the benchmark runs loads JAX: the check compares each loaded
module's top-level name whole (the port's name begins with the JAX
package's), the references load nothing of the port, and without a card a
run exits with 2 and prints no result."""

import os
import subprocess
import sys

from port_bench import harness
from port_bench.tests.conftest import REPO


def test_forbidden_by_whole_top_level_name(monkeypatch):
    for name in ("i2v_tpu_torch", "i2v_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    before = harness.forbidden_modules()
    assert "i2v_tpu_torch" not in before and "jaxtyping" not in before
    for name in ("i2v_tpu.models", "jaxlib.xla_client", "optax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"i2v_tpu", "jaxlib", "optax"} <= set(harness.forbidden_modules())


_SCRIPT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "i2v_tpu", "i2v_tpu_torch"):
    sys.modules[name] = None
import port_bench.reference.surrogates, port_bench.reference.video, port_bench.reference.i2v
import port_bench.build, port_bench.gen, port_bench.flops, port_bench.trace
import port_bench.readers, port_bench.weights, port_bench.traffic, port_bench.harness
"""


def test_references_import_nothing_of_the_port():
    subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, check=True, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "ens_i2v.b16",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == "", (proc.returncode, proc.stdout)
