"""The harness is driven by files: a cell, its traffic mix and a per-layer
metric added as new files (and entries in ``BENCHMARK.json``) load by name
and run, with no edit to any file the benchmark has."""

import json
import os
import shutil

import pytest
import torch

from port_bench import harness
from port_bench.tests.conftest import REPO


def test_new_cell_and_metric_load_by_name(tmp_path, run_tiny):
    root = tmp_path / "port_bench"
    shutil.copytree(os.path.join(REPO, "port_bench"), root,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    (root / "traffic" / "b2_three.json").write_text(json.dumps(
        {"batch": 2, "steps_per_call": 3, "frame_chunk": "auto"}))
    (root / "workloads" / "ens_i2v.b2_three.json").write_text(json.dumps(
        {"entry": "runner_i2v", "limits": json.loads(
            (root / "workloads" / "ens_i2v.b16.json").read_text())["limits"]}))
    (root / "metrics" / "calls_per_s.new.py").write_text(
        "def read(ctx):\n    return ctx.counts['calls'] / ctx.window_s\n")
    spec = harness.load_json(os.path.join(REPO, "BENCHMARK.json"))
    spec["workloads"].append({"name": "ens_i2v.b2_three", "config": "ens_i2v",
                              "traffic": "b2_three", "chips": 1, "why": "test"})
    next(m for m in spec["end_to_end"] if m["name"] == "adv_clips_per_s")["workloads"].append(
        "ens_i2v.b2_three")
    spec["per_layer"].append({"name": "calls_per_s.new", "unit": "1/s", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "adv_clips_per_s", "workloads": ["ens_i2v.b2_three"]})
    bench = harness.Bench(spec, str(root))
    out = run_tiny("ens_i2v.b2_three", bench=bench, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["calls_per_s.new"]["value"] > 0
    assert "rebuild_roofline" not in out["metrics"]  # lists other cells only
    out = run_tiny("ens_i2v.b2_three", bench=bench)
    assert set(out["metrics"]) == {"adv_clips_per_s", "setup_s"}  # no card: no peak


def test_metrics_follow_workloads_and_moves():
    bench = harness.Bench.at(REPO)
    for w in bench.spec["workloads"]:
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        layer = bench.per_layer(w["name"])
        assert "setup_s" in e2e and "peak_mem_gib" in e2e and len(e2e) >= 3
        assert layer and all(m["moves"] in e2e for m in layer)
        for m in layer:
            assert os.path.exists(os.path.join(REPO, "port_bench", "metrics", m["name"] + ".py"))
    spec = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
            "per_layer": [{"name": "c", "moves": "a"}, {"name": "d", "moves": "b"}],
            "workloads": []}
    bench = harness.Bench(spec)
    assert [m["name"] for m in bench.per_layer("y")] == ["c"]
    assert [m["name"] for m in bench.per_layer("x")] == ["c", "d"]


def test_numerics_come_from_the_configuration():
    f32 = {"precision": "float32", "tf32": False}
    assert harness.numerics(f32, None) == (torch.float32, False)
    assert harness.numerics(f32, "tf32") == (torch.float32, True)
    assert harness.numerics(f32, "bf16") == (torch.bfloat16, False)
    assert harness.numerics(dict(f32, tf32=True), None) == (torch.float32, True)
    assert harness.numerics({"precision": "bfloat16"}, None) == (torch.bfloat16, False)
    for config, control in ((dict(f32, tf32=True), "tf32"), ({"precision": "bfloat16"}, "bf16")):
        with pytest.raises(ValueError):
            harness.numerics(config, control)
