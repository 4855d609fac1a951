"""The port's ``cli.report`` and ``cli.run_grid`` against the JAX CLIs.

``report`` reads the same run directories as the JAX CLI and writes the same
bytes (CSV and markdown, bare run names, a missing report's note,
``--merge_shards``). ``run_grid`` is driven with the generate and evaluate
mains stubbed to record their argv: every grid makes the JAX grid's
(generate, evaluate) sequence, with ``--device`` the only flag added to the
evaluate calls. One real ``layer_ablation --limit 1 --tiny --device cpu``
run closes it.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.cli import report as jreport  # noqa: E402
from i2v_tpu.cli import run_grid as jrun_grid  # noqa: E402
from i2v_tpu_torch.cli import report, run_grid  # noqa: E402

MODELS = ("i3d_resnet50", "slowfast_resnet101", "tpn_resnet50")


@pytest.fixture(autouse=True)
def tf32_flags_restored(monkeypatch):
    """The port's CLIs set torch's process-wide TF32 flags
    (``--matmul_precision``); they are put back after each test."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)


def _runs(root):
    """Three evaluated run dirs (one with a model the others lack) and one
    that was not evaluated."""
    rng = np.random.RandomState(0)
    for i, name in enumerate(["Image-A-60-x", "Image-B-60-x", "Video-C-10-y"]):
        os.makedirs(root / name)
        models = MODELS if i < 2 else MODELS + ("i3d_resnet101",)
        with open(root / name / "top1_acc_all_models.json", "w") as f:
            json.dump({m: float(rng.rand() * 100) for m in models}, f)
    os.makedirs(root / "Image-D-60-unevaluated")


@pytest.mark.parametrize("fmt", ["csv", "markdown"])
def test_report_bytes_equal_the_jax_cli(fmt, tmp_path, monkeypatch):
    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    _runs(tmp_path)
    tables = {}
    for label, mod in (("jax", jreport), ("port", report)):
        out = tmp_path / f"{label}.{fmt}"
        tables[label] = mod.main(["--format", fmt, "--out", str(out)])
        with open(out, "rb") as f:
            tables[label + " file"] = f.read()
    assert tables["port"] == tables["jax"] and tables["port file"] == tables["jax file"]
    assert tables["port"].count("\n") == (3 if fmt == "csv" else 4)


def test_report_resolves_bare_run_names_and_notes_missing_ones(tmp_path, monkeypatch,
                                                                capsys):
    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    _runs(tmp_path)
    argv = ["--runs", "Image-B-60-x", str(tmp_path / "Video-C-10-y"), "Image-D-60-unevaluated",
            "no-such-run", "--format", "markdown"]
    outs = []
    for mod in (jreport, report):
        mod.main(argv)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[1].count("[report] skipping") == 2
    with pytest.raises(SystemExit, match="no top1_acc_all_models.json"):
        report.main(["--runs", "no-such-run"])


def test_report_merge_shards_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """Two fused shards' suffixed reports merge into the plain pair, the JAX
    CLI's bytes, found by bare run name."""
    from i2v_tpu_torch.eval.transfer import write_reports

    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    merged = {}
    for label, mod in (("jax", jreport), ("port", report)):
        run = tmp_path / f"Image-I2V-60-{label}"
        os.makedirs(run)
        for k, labels in ((1, (0, 5)), (2, (7, 9))):
            cols = {m: [-1] * 10 for m in MODELS}
            for j, m in enumerate(MODELS):
                for lab in labels:
                    cols[m][lab] = (lab + j) % 3
            write_reports(str(run), cols, 10, {m: 50.0 for m in MODELS}, suffix=f"_{k}")
        printed = mod.main(["--merge_shards", run.name])
        assert capsys.readouterr().out == printed + "\n"
        merged[label] = [printed] + [open(run / f, "rb").read() for f in (
            "results_all_models_prediction.csv", "top1_acc_all_models.json")]
    assert merged["port"] == merged["jax"]


class _Recorder:
    """Stand-ins for the generate and evaluate mains that record argv."""

    def __init__(self):
        self.calls = []

    def gen(self, argv):
        self.calls.append(("gen", list(argv)))
        return "RUN_" + argv[argv.index("--file_prefix") + 1]

    def eval(self, argv):
        self.calls.append(("eval", list(argv)))
        return {}


def _calls_made(monkeypatch, grid_module, argv):
    from i2v_tpu.cli import evaluate as jev
    from i2v_tpu.cli import evaluate_ucf101 as jev101
    from i2v_tpu.cli import image_main as jim
    from i2v_tpu.cli import image_main_ucf101 as jim101
    from i2v_tpu_torch.cli import evaluate, evaluate_ucf101, image_main, image_main_ucf101

    rec = _Recorder()
    mods = ((jim, jim101, jev, jev101) if grid_module is jrun_grid
            else (image_main, image_main_ucf101, evaluate, evaluate_ucf101))
    for mod, fn in zip(mods, (rec.gen, rec.gen, rec.eval, rec.eval)):
        monkeypatch.setattr(mod, "main", fn)
    grid_module.main(argv)
    return rec.calls


@pytest.mark.parametrize("argv", [
    ["steps_ablation"],
    ["layer_ablation"],
    ["kinetics_perf", "--tiny"],
    ["ucf101_perf", "--step", "2"],
    ["layer_ablation", "--limit", "3", "--eval_single_pass", "--tiny"],
    ["kinetics_perf", "--fused"],
    ["steps_ablation", "--fused", "i3d_resnet50", "--limit", "2"],
], ids=["steps", "layers", "kinetics", "ucf101", "limit-single-pass", "fused", "fused-limit"])
def test_run_grid_makes_the_jax_grids_calls_plus_device(argv, monkeypatch):
    want = _calls_made(monkeypatch, jrun_grid, argv)
    got = _calls_made(monkeypatch, run_grid, argv + ["--device", "cpu"])
    assert len(got) == len(want) > 0
    for (kind, g), (wkind, w) in zip(got, want):
        assert kind == wkind
        if kind == "gen":
            assert g == w + ["--device", "cpu"] or (
                "--fused_eval" in w and g == w[:-2] + ["--device", "cpu"] + w[-2:])
        else:
            assert g == w + ["--device", "cpu"]
    n = {"steps_ablation": 25, "layer_ablation": 16, "kinetics_perf": 9, "ucf101_perf": 9}
    limit = int(argv[argv.index("--limit") + 1]) if "--limit" in argv else None
    fused = "--fused" in argv
    assert sum(k == "gen" for k, _ in got) == (limit or n[argv[0]])
    assert sum(k == "eval" for k, _ in got) == (0 if fused else (limit or n[argv[0]]))


def test_run_grid_limit_is_fresh_for_every_call_and_passes_precision(monkeypatch):
    first = _calls_made(monkeypatch, run_grid, ["layer_ablation", "--limit", "1"])
    again = _calls_made(monkeypatch, run_grid, ["layer_ablation", "--limit", "1",
                                            "--matmul_precision", "float32"])
    assert len(first) == len(again) == 2
    assert again[1][1][-2:] == ["--matmul_precision", "float32"]


def test_run_grid_one_real_tiny_config_on_the_cpu(tmp_path, monkeypatch):
    """``layer_ablation --limit 1`` through the port's image_main and
    evaluate: ResNet depth 1, one synthetic clip, the two reports."""
    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    run_grid.main(["layer_ablation", "--limit", "1", "--tiny", "--device", "cpu", "--step", "1",
                   "--n_synthetic", "1", "--clip_len", "4"])
    (run,) = os.listdir(tmp_path)
    assert run == "Image-ImageGuidedFMDirection_Adam-1-synthetic-layers_resnet_1"
    files = sorted(os.listdir(tmp_path / run))
    assert files == ["0-adv.npy", "loss_info_1.json", "results_all_models_prediction.csv",
                     "top1_acc_all_models.json"]
    with open(tmp_path / run / "top1_acc_all_models.json") as f:
        assert len(json.load(f)) == 6
