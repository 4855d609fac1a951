"""The MViTv2-B evaluation cell through the whole harness on the CPU at tiny
sizes: the port passes the check, a bfloat16 program fails it, and so does
the MViT model with its relative terms dropped in the port's module, half a
batch's logits copied, or a prediction altered where it is produced. The
counts behind the pooling-attention kernel's roofline follow the published
geometry."""

import pytest
import torch

from port_bench import harness, pool_attn
from port_bench.reference import mvit as ref_mvit
from port_bench.tests import test_port_bench_correct as correct
from port_bench.tests.conftest import REPO, SEED

from i2v_tpu_torch.models import mvit

MVIT = "mvit_v2_b_eval.single_b16"
# the port's test variant (models/mvit.py TINY) at 8 x 32^2
TINY = {"config": dict(ref_mvit.TINY, tiny=True, reference_block=2),
        "traffic": {"artifacts": 4, "sweep_clips": 6, "batch": 2}}


def _run(workload, control=None, trace=False):
    bench = harness.Bench.at(REPO)
    return harness.run_cell(bench, workload, seed=SEED, seconds=0.01, trace=trace,
                            device="cpu", t_start=0.0, overrides=TINY,
                            control=control, log=lambda *a: None)


def test_port_is_correct():
    out = _run(MVIT)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"eval_clips_per_s", "setup_s"}  # no card: no peak


def test_bf16_control_fails():
    out = _run(MVIT, control="bf16")
    assert not out["correct"], out["checks"]


def _dropped_relative_terms(monkeypatch):
    terms = mvit.relative_terms
    monkeypatch.setattr(mvit, "relative_terms",
                        lambda *a: tuple(torch.zeros_like(t) for t in terms(*a)))


@pytest.mark.parametrize("fault", [_dropped_relative_terms, correct._half_clips,
                                   correct._altered_pred])
def test_fault_fails(monkeypatch, fault):
    fault(monkeypatch)
    out = _run(MVIT)
    assert not out["correct"], (fault.__name__, out["checks"])


def test_launch_counts_follow_the_published_geometry():
    config = harness.Bench.at(REPO).config("mvit_v2_b_eval")
    blocks = pool_attn.blocks(config)
    assert len(blocks) == 24
    # stage 1: 50177 queries on 785 keys, one head; block 2: 12545 on 3137, two;
    # the last: 785 on 785, eight heads; head dim 96 throughout
    assert blocks[0] == (1, 50177, 785, 96, 16 + 7 + 7)
    assert blocks[2] == (2, 12545, 3137, 96, 16 + 14 + 14)
    assert blocks[21] == (8, 785, 3137, 96, 16 + 14 + 14)
    assert blocks[-1] == (8, 785, 785, 96, 16 + 7 + 7)
    flops = sum(f for f, _ in pool_attn.launch_work(config, 1))
    assert flops == sum(4 * h * nq * nk * hd for h, nq, nk, hd, _ in blocks)
    assert 158.7e9 < flops < 158.9e9  # the attention's 79.4 G multiply-adds a clip
    # the port builds the same blocks
    specs = mvit.block_specs(mvit.MVIT_V2_B)
    assert [(s.heads, s.head_dim) for s in specs] == [(h, hd) for h, _, _, hd, _ in blocks]

