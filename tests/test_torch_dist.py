"""Multi-process launches in the port (``i2v_tpu_torch.parallel.dist``): the
per-process sample shards against the JAX package's, the CLI's shard bounds
and loss-log ids under a launch, and one real launch of two ``gloo``
processes through ``cli.image_main``, evaluated as one run.

The workers import the port and torch only (no JAX) and compute on one
thread each; the one-process run they are held against computes on one
thread too (``tests/torch_threads.py``), so that the artifacts, and so the
reports, are the same bytes.
"""

import argparse
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.parallel import dist as jdist  # noqa: E402
from i2v_tpu_torch.cli import common, evaluate, image_main  # noqa: E402
from i2v_tpu_torch.parallel import dist  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV, JSON = "results_all_models_prediction.csv", "top1_acc_all_models.json"
ARGV = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--tiny", "--n_synthetic", "4",
        "--batch_size", "2", "--step", "2", "--device", "cpu", "--file_prefix", "mp"]
RUN = "Image-ImageGuidedFML2_Adam_MultiModels-2-synthetic-mp"

WORKER = """
import sys
sys.modules["jax"] = None   # the port's workers run without JAX
import torch
torch.set_num_threads(1)
from i2v_tpu_torch.cli import image_main
from i2v_tpu_torch.ops import kernels
from i2v_tpu_torch.parallel import dist
image_main.main({argv!r})
print("WORKER_DONE", dist.process_index(), dist.process_count(), dict(kernels.launches))
"""


@pytest.mark.parametrize("n,shards,index", [
    (10, 1, 0), (10, 2, 0), (10, 2, 1), (10, 3, 2), (7, 4, 3), (3, 4, 0), (400, 8, 7),
    (5, 2, 2), (5, 2, -1), (5, 0, 0),
])
def test_process_shard_bounds_match_jax(n, shards, index):
    try:
        want = jdist.process_shard_bounds(n, shards, index)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            dist.process_shard_bounds(n, shards, index)
        assert str(err.value) == str(e)
        return
    assert dist.process_shard_bounds(n, shards, index) == want


def test_shard_bounds_and_loss_index_follow_the_launch(monkeypatch):
    """Under a launch of two processes, with the flags at their defaults,
    process 1 takes the second half of the samples and writes
    loss_info_2.json; explicit flags still win; with no launch both are the
    reference's contract."""
    args = argparse.Namespace(batch_nums=1, batch_index=1)
    assert common.shard_bounds(args, 5) == (0, 5) and common.loss_shard_index(args) == 1
    monkeypatch.setattr(dist, "maybe_initialize_distributed", lambda: True)
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "process_index", lambda: 1)
    assert common.shard_bounds(args, 5) == (2, 5) and common.loss_shard_index(args) == 2
    args = argparse.Namespace(batch_nums=5, batch_index=2)
    assert common.shard_bounds(args, 10) == (2, 4) and common.loss_shard_index(args) == 2
    with pytest.raises(SystemExit, match="out of range for 5 shards"):
        common.shard_bounds(argparse.Namespace(batch_nums=5, batch_index=0), 10)


def test_launch_contract(monkeypatch):
    """No launch: nothing to join. torchrun's variables and SLURM's name the
    rank; a launch without MASTER_ADDR is refused before any rendezvous; a
    process's card needs a card."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_NTASKS", "SLURM_PROCID",
                "SLURM_LOCALID", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert dist._launch_env() is None and not dist.maybe_initialize_distributed()
    assert (dist.process_count(), dist.process_index()) == (1, 0)
    monkeypatch.setenv("SLURM_NTASKS", "3")
    monkeypatch.setenv("SLURM_PROCID", "2")
    assert dist._launch_env() == {"rank": 2, "world_size": 3, "local_rank": 0}
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert dist._launch_env() == {"rank": 1, "world_size": 2, "local_rank": 1}
    with pytest.raises(RuntimeError, match="needs MASTER_ADDR"):
        dist.maybe_initialize_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.local_device()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reports(run_dir):
    with open(os.path.join(run_dir, CSV), "rb") as f, open(os.path.join(run_dir, JSON), "rb") as g:
        return f.read(), g.read()


def test_two_processes_write_one_run_that_evaluates_as_one_process(tmp_path, monkeypatch):
    two, one = str(tmp_path / "two"), str(tmp_path / "one")
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), I2V_TPU_OPT_PATH=two,
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER.format(argv=ARGV)],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    for rank, out in enumerate(outs):
        assert f"WORKER_DONE {rank} 2 " in out
    run_two = os.path.join(two, RUN)
    assert sorted(os.listdir(run_two)) == ["0-adv.npy", "1-adv.npy", "2-adv.npy", "3-adv.npy",
                                           "loss_info_1.json", "loss_info_2.json"]

    monkeypatch.setenv("I2V_TPU_OPT_PATH", one)
    assert torch.get_num_threads() == 1
    run_one = image_main.main(ARGV)
    for label in range(4):
        np.testing.assert_array_equal(np.load(os.path.join(run_two, f"{label}-adv.npy")),
                                      np.load(os.path.join(run_one, f"{label}-adv.npy")))
    for run in (run_two, run_one):
        evaluate.main(["--adv_path", run, "--tiny", "--device", "cpu",
                       "--models", "i3d_resnet50", "--batch_size", "2"])
    assert _reports(run_two) == _reports(run_one)
