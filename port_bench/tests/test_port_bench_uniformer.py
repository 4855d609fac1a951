"""The UniFormer-B evaluation cell through the whole harness on the CPU at
tiny sizes: the port passes the check, a bfloat16 program fails it, and so
does the model with its 5³ local affinity or its DPE dropped in the port's
module, half a batch's logits copied, or a prediction altered where it is
produced. The counts behind the depthwise conv kernel's roofline follow the
published geometry and equal a hand count on the tiny one."""

import pytest
import torch

from port_bench import dwconv3d, harness
from port_bench.reference import uniformer as ref_uniformer
from port_bench.tests import test_port_bench_correct as correct
from port_bench.tests.conftest import REPO, SEED

from i2v_tpu_torch.models import uniformer

UNIFORMER = "uniformer_b_eval.single_b16"
# the port's test variant (models/uniformer.py TINY) at 8 x 64^2
TINY = {"config": dict(ref_uniformer.TINY, tiny=True, reference_block=2),
        "traffic": {"artifacts": 4, "sweep_clips": 6, "batch": 2}}


def _run(workload, control=None, trace=False):
    bench = harness.Bench.at(REPO)
    return harness.run_cell(bench, workload, seed=SEED, seconds=0.01, trace=trace,
                            device="cpu", t_start=0.0, overrides=TINY,
                            control=control, log=lambda *a: None)


def test_port_is_correct():
    out = _run(UNIFORMER)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"eval_clips_per_s", "setup_s"}  # no card: no peak


def test_bf16_control_fails():
    out = _run(UNIFORMER, control="bf16")
    assert not out["correct"], out["checks"]


def _dropped_local_affinity(monkeypatch):
    conv = uniformer.dwconv3d
    monkeypatch.setattr(uniformer, "dwconv3d", lambda x, thw, c, residual: (
        conv(x, thw, c, residual) if residual else torch.zeros_like(x)))


def _dropped_dpe(monkeypatch):
    conv = uniformer.dwconv3d
    monkeypatch.setattr(uniformer, "dwconv3d", lambda x, thw, c, residual: (
        x if residual else conv(x, thw, c, residual)))


@pytest.mark.parametrize("fault", [_dropped_local_affinity, _dropped_dpe, correct._half_clips,
                                   correct._altered_pred])
def test_fault_fails(monkeypatch, fault):
    fault(monkeypatch)
    out = _run(UNIFORMER)
    assert not out["correct"], (fault.__name__, out["checks"])


def test_launch_counts_follow_the_published_geometry():
    config = harness.Bench.at(REPO).config("uniformer_b_eval")
    plan = dwconv3d.launches(config)
    assert len(plan) == 53
    # stage 1: a DPE and a 5³ a block over 16 x 56^2 at 64 channels; the last:
    # stage 4's DPE over 16 x 7^2 at 512
    assert plan[:2] == [(3, 64, 50176), (5, 64, 50176)]
    assert plan[10:12] == [(3, 128, 12544), (5, 128, 12544)]
    assert plan[26] == (3, 320, 3136) and plan[-1] == (3, 512, 784)
    work = dwconv3d.launch_work(config, 1)
    assert 10.02e9 < sum(f for f, _ in work) < 10.03e9  # 5.0 G tap multiply-adds a clip
    assert 645.4e6 < sum(b for _, b in work) < 645.5e6
    # the tiny geometry by hand: grids 4x16x16, 4x8x8, 4x4x4, 4x2x2 at widths
    # 32, 64, 128, 192; one conv block in stages 1-2 (3³ and 5³), two then
    # one attention block (3³)
    by_hand = [(2 * 27 * 32 * 1024, 2 * 32 * 1024 * 4), (2 * 125 * 32 * 1024, 2 * 32 * 1024 * 4),
               (2 * 27 * 64 * 256, 2 * 64 * 256 * 4), (2 * 125 * 64 * 256, 2 * 64 * 256 * 4),
               (2 * 27 * 128 * 64, 2 * 128 * 64 * 4), (2 * 27 * 128 * 64, 2 * 128 * 64 * 4),
               (2 * 27 * 192 * 16, 2 * 192 * 16 * 4)]
    assert dwconv3d.launch_work(ref_uniformer.TINY, 1) == by_hand
    assert dwconv3d.launch_work(ref_uniformer.TINY, 3, 2) == \
        [(3 * f, 3 * b // 2) for f, b in by_hand]
