"""The Swin-B evaluation cell through the whole harness on the CPU at tiny
sizes: the port passes the check, a
bfloat16 program fails it, and so does the Swin model with its relative
bias dropped in the port's module, half a batch's logits copied, or a
prediction altered where it is produced. The counts behind the window-attention
kernel's roofline follow the published geometry."""

import pytest
import torch

from port_bench import harness, window_attn
from port_bench.tests import test_port_bench_correct as correct
from port_bench.tests.conftest import REPO, SEED

from i2v_tpu_torch.models import swin3d

SWIN = "swin3d_b_eval.single_b16"
TINY = {"config": {"tiny": True, "hw": 32, "frames": 8, "reference_block": 2,
                   "embed_dim": 32, "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8],
                   "window_size": [4, 3, 3]},
        "traffic": {"artifacts": 4, "sweep_clips": 6, "batch": 2}}


def _run(workload, control=None, trace=False):
    bench = harness.Bench.at(REPO)
    return harness.run_cell(bench, workload, seed=SEED, seconds=0.01, trace=trace,
                            device="cpu", t_start=0.0, overrides=TINY,
                            control=control, log=lambda *a: None)


def test_port_is_correct():
    out = _run(SWIN)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"eval_clips_per_s", "setup_s"}  # no card: no peak


def test_bf16_control_fails():
    out = _run(SWIN, control="bf16")
    assert not out["correct"], out["checks"]


def _dropped_relative_bias(monkeypatch):
    attention = swin3d.window_attention

    def no_bias(qkv, table, geo):
        return attention(qkv, torch.zeros_like(table), geo)

    monkeypatch.setattr(swin3d, "window_attention", no_bias)


@pytest.mark.parametrize("fault", [_dropped_relative_bias, correct._half_clips,
                                   correct._altered_pred])
def test_fault_fails(monkeypatch, fault):
    fault(monkeypatch)
    out = _run(SWIN)
    assert not out["correct"], (fault.__name__, out["checks"])


def test_launch_counts_follow_the_published_geometry():
    config = harness.Bench.at(REPO).config("swin3d_b_eval")
    blocks = window_attn.blocks(config)
    assert len(blocks) == 24
    # stage 1: 2·8·8 windows of 8·7·7 tokens, 4 heads; stage 4: 2 windows, 32 heads
    assert blocks[0] == (128 * 4, 392, 32, 2535 * 4)
    assert blocks[-1] == (2 * 32, 392, 32, 2535 * 32)
    flops = sum(f for f, _ in window_attn.launch_work(config, 1, 4))
    assert flops == sum(4 * wh * n * n * hd for wh, n, hd, _ in blocks)
    assert 77e9 < flops < 79e9  # the attention's 39.0 G multiply-adds a clip
