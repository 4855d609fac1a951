"""Shared set-up of the benchmark's CPU tests: the cells at tiny sizes (the
port's width-reduced test models, a few frames), run through the whole
harness on the CPU, where the port takes its kernels' plain versions and
runs its graphs eagerly."""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from port_bench import harness  # noqa: E402

TINY = {
    "ens_i2v": {"config": {"tiny": True, "hw": 64, "frames": 4, "steps": 6, "reference_block": 4},
                "traffic": {"batch": 2, "steps_per_call": 3, "frame_chunk": 4, "pool_clips": 2}},
    "video6_eval": {"config": {"tiny": True, "hw": 32, "frames": 8, "reference_block": 2},
                    "traffic": {"artifacts": 4, "sweep_clips": 6, "batch": 2}},
}
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def run_tiny():
    """``run_tiny(workload, bench=None, traffic=None, **kw)`` → the result
    line's object of one tiny run on the CPU. Its window is so short that it
    runs one unit: at these sizes a runner call is the second of its batch,
    resumed from the first; ``traffic={"steps_per_call": 6}`` makes it a
    new batch's first call instead."""

    def run(workload, bench=None, trace=False, control=None, seed=SEED, traffic=None):
        bench = bench or harness.Bench.at(REPO)
        tiny = TINY[bench.workload(workload)["config"]]
        overrides = {"config": tiny["config"], "traffic": dict(tiny["traffic"], **(traffic or {}))}
        return harness.run_cell(bench, workload, seed=seed, seconds=0.01, trace=trace,
                                device="cpu", t_start=0.0, overrides=overrides,
                                control=control, log=lambda *a: None)

    return run


@pytest.fixture
def cuda():
    """The first CUDA card; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
