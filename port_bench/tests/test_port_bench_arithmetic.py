"""The yardstick's arithmetic: the rebuild kernels' bytes, the FLOPs of an
ENS-I2V step counted on the frozen reference against the conv layers' own
count (and the count PERF_PROBE_TORCH.json records for the port), and the
idle share and its gaps on a synthetic trace."""

import pytest
import torch

from port_bench import flops, readers, trace
from port_bench.harness import Context
from port_bench.reference import surrogates

ENS_STEP_FLOPS = 29_600_751_812_608   # PERF_PROBE_TORCH.json, cost_ens16_f32_chunk256
ENS_CLEAN_FLOPS = 14_801_904_730_112


def test_rebuild_bytes():
    numel = 32 * 3 * 224 * 224
    assert flops.rebuild_fwd_bytes(numel) == 57_802_752      # 57.8 MB
    assert flops.rebuild_bwd_bytes(numel) == 77_070_336      # 77.1 MB


def test_ens_step_flops_at_b16():
    with torch.device("meta"):
        models = [surrogates.build(n, d) for n, d in surrogates.ENS]
    step, clean = flops.gen_flops(models, 16 * 32, 224)
    assert step == flops.analytic_conv_flops(models, 16 * 32, 224) == ENS_STEP_FLOPS
    assert clean == ENS_CLEAN_FLOPS


def _x(name, ts, dur, cat, tid=1):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "pid": 1, "tid": tid}


def test_idle_and_gaps_on_a_synthetic_trace():
    events = [
        _x(trace.WINDOW, 100, 1000, "user_annotation"),
        _x("port_bench.unit", 100, 1000, "user_annotation"),
        _x("cudaStreamSynchronize", 700, 300, "cpu_op"),
        _x("aten::copy_", 900, 50, "cpu_op", tid=2),            # another thread
        _x("void rebuild_fwd_kernel<true>(...)", 50, 150, "kernel"),   # clipped to 100..200
        _x("sm90_xmma_fprop_implicit_gemm", 150, 250, "kernel"),  # overlaps: 100..400
        _x("Memcpy HtoD (Pinned -> Device)", 500, 100, "gpu_memcpy"),
        _x("elementwise_kernel", 1150, 100, "kernel"),          # after the window
    ]
    s = trace.summarize(events)
    assert s.window_us == 1000 and s.busy_us == 300 + 100
    assert [round(d) for _, d in s.gaps] == [500, 100]        # 600..1100, 400..500
    assert s.gaps[0][0] == "cudaStreamSynchronize" and s.gaps[1][0] == "port_bench.unit"
    ctx = Context({}, {}, 1.0, 1e-3, {"steps": 2, "batches": 2}, 0, "NVIDIA H100 80GB HBM3",
                  {"flops": 67e12 * 1e-3 / 2,
                   "rebuild_bytes": {"rebuild_fwd_kernel": 3.35e12 * 100e-6 / 2}}, s)
    assert readers.idle_percent(ctx) == pytest.approx(60.0)
    assert readers.mfu_percent(ctx) == pytest.approx(50.0)
    assert readers.conv_ms(ctx) == pytest.approx(0.25)
    assert trace.kernel_class("void rebuild_bwd_kernel<false>") == "K1+K2"
    from port_bench.harness import Bench

    bench = Bench({})
    roof = bench.module("metrics", "rebuild_roofline").read(ctx)
    assert roof == pytest.approx(50.0)
    assert bench.module("metrics", "h2d_ms_per_batch.eval").read(ctx) == pytest.approx(0.05)
    assert readers.mfu_percent(Context({}, {}, 1.0, 1.0, {}, 0, "cpu", {"flops": 1.0})) is None
