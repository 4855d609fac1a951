"""``tools/torch_e2e_400.py`` against ``tools/e2e_400.py``: the synthetic
uint8 source byte for byte, the summary's accounting on the same progress
marks and reports, and one hard kill and resume at a tiny size on the CPU.

The kill and the resume each run in a subprocess with a tiny pipeline in
place of ``build_pipeline``: the tiny ResNet + VGG ensemble (the port's
runner with ``frame_chunk=256``, its u8 ingress) over an 8-frame 32² corner
of each synthetic clip, and two tiny video models, as the port's fused tests
build them. Nothing is written in the repo: the JAX summary's ``ARTIFACT``
and its ``record`` are pointed at the test's directory and a stub."""

import csv
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

import tools.e2e_400 as jtool  # noqa: E402
import tools.perf_probe as jprobe  # noqa: E402
from i2v_tpu_torch.cli import evaluate  # noqa: E402
from i2v_tpu_torch.utils import artifacts  # noqa: E402
from tools import torch_e2e_400 as tool  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV, JSON = "results_all_models_prediction.csv", "top1_acc_all_models.json"
MODELS = ("i3d_resnet50", "slowfast_resnet50")
CLIPS, BATCH, STEPS = 6, 2, 2


@pytest.mark.parametrize("labels", [[3, 7], [7, 3], [0, 399, 12]])
def test_synthetic_clips_are_the_jax_tools_bytes(labels):
    ours = tool.synth_u8_batch(labels)
    assert ours.dtype == np.uint8 and ours.shape == (len(labels), 32, 224, 224, 3)
    assert ours.tobytes() == jtool.synth_u8_batch(labels).tobytes()
    # per-label: the order of the labels does not change a clip
    np.testing.assert_array_equal(ours[0], tool.synth_u8_batch(labels[::-1])[-1])


def _marks_and_reports(d):
    """A killed phase A (setup, four batches, no finalize) and a phase B that
    re-scored 32 clips and attacked four batches, with reports and artifacts."""
    tool.mark(d, phase="A", event="setup", setup_s=12.5)
    for i, wall in enumerate((30.0, 41.0, 52.5, 63.0)):
        tool.mark(d, phase="A", event="batch", batch=i, clips_done=(i + 1) * 8, wall_s=wall)
    tool.mark(d, phase="B", event="setup", setup_s=10.0)
    tool.mark(d, phase="B", event="rescored", clips=32, wall_s=20.0)
    for i, wall in enumerate((25.0, 35.0, 46.0, 56.0)):
        tool.mark(d, phase="B", event="batch", batch=i, clips_done=(i + 1) * 8, wall_s=wall)
    tool.mark(d, phase="B", event="finalized", attack_wall_s=3000.0, finalize_wall_s=5.0)
    rng = np.random.RandomState(0)
    with open(os.path.join(d, CSV), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["gt_label"] + [f"{m}-pre" for m in MODELS])
        for lab in range(400):
            preds = rng.randint(0, 400, 2)
            if lab in (5, 17):
                preds[lab % 2] = -1
            w.writerow([lab, *preds])
    with open(os.path.join(d, JSON), "w") as f:
        json.dump({m: 0.25 for m in MODELS}, f)
    for lab in range(398):
        open(os.path.join(d, artifacts.adv_filename(lab)), "wb").close()
    open(os.path.join(d, "398-adv.npy.tmp.npy"), "wb").close()


def test_summary_is_the_jax_tools_accounting(tmp_path, monkeypatch):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    _marks_and_reports(str(run_dir))
    monkeypatch.setattr(jtool, "ARTIFACT", str(tmp_path / "E2E_400.json"))
    monkeypatch.setattr(jprobe, "record", lambda key, payload: None)
    jtool.summarize(type("A", (), {"run_dir": str(run_dir)})())
    with open(tmp_path / "E2E_400.json") as f:
        want = json.load(f)
    out_dir = tmp_path / "port"
    got = tool.summarize(tool.arg_parse(["--run_dir", str(run_dir), "--out_dir",
                                         str(out_dir)]))
    for key in ("phase_a", "phase_b", "total_measured_wall_s", "clips_per_s_end_to_end",
                "steady_state_clips_per_s", "steady_state_clips_per_s_phase_a",
                "artifact_count", "report_rows", "labels_fully_covered", "top1_acc", "clips",
                "batch"):
        assert got[key] == want[key], key
    assert got["artifact_count"] == 398 and got["labels_fully_covered"] == 398
    assert sorted(os.listdir(out_dir)) == ["E2E_400_TORCH.json", "PERF_PROBE_TORCH.json"]
    with open(out_dir / "PERF_PROBE_TORCH.json") as f:
        row = json.load(f)["exec_e2e400"]
    assert row["clips_per_s_end_to_end"] == want["clips_per_s_end_to_end"]
    assert row["card"] == {"device": "cpu"}


_TINY_RUN = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
import tools.torch_e2e_400 as e2e
from i2v_tpu_torch.eval.fused import FusedGenerateEvaluate
from i2v_tpu_torch.models import get_image_models, get_video_model
from i2v_tpu_torch.parallel.sharded import ShardedImageGuidedAttack


def tiny_pipeline(run_dir, args):
    surrogates = get_image_models(["resnet", "vgg"], {{"resnet": 2, "vgg": 3}},
                                  device=args.device, tiny=True, input_hw=32)
    runner = ShardedImageGuidedAttack(surrogates, steps=args.steps, step_size=0.005,
                                      frame_chunk=256)

    def attack(clips, labels, names):
        # an 8-frame 32x32 corner of each uint8 clip, through the u8 ingress
        assert clips.dtype == np.uint8 and clips.shape[1:] == (32, 224, 224, 3)
        return runner(clips[:, :8, :32, :32], labels, names)

    bundles = {{n: get_video_model(n, device=args.device, tiny=True) for n in {models!r}}}
    return FusedGenerateEvaluate(attack, bundles, run_dir=run_dir, n_classes=args.clips,
                                 artifact_dtype=np.float16)


e2e.build_pipeline = tiny_pipeline
e2e.main(sys.argv[1:])
"""


def _phase(run_dir, out_dir, *flags):
    argv = ["--run_dir", run_dir, "--out_dir", out_dir, "--device", "cpu", "--clips",
            str(CLIPS), "--batch", str(BATCH), "--steps", str(STEPS), *flags]
    return subprocess.run([sys.executable, "-c", _TINY_RUN.format(repo=REPO, models=MODELS),
                           *argv], cwd=REPO, capture_output=True, text=True, timeout=300)


def _report(run_dir):
    with open(os.path.join(run_dir, CSV), newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], {int(r[0]): [int(c) for c in r[1:]] for r in rows[1:]}


def test_a_killed_run_resumes_to_complete_reports(tmp_path):
    run_dir, out_dir = str(tmp_path / "run"), str(tmp_path / "out")
    a = _phase(run_dir, out_dir, "--kill_after_batches", "2")
    assert a.returncode == 137, a.stdout + a.stderr
    assert "[e2e400:A] hard kill after batch 2" in a.stdout
    launches = json.loads(a.stdout.strip().splitlines()[-1].split("launches ", 1)[1])
    # on the CPU the wrappers take the kernels' plain versions
    assert launches == {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": 0}
    assert not os.path.exists(os.path.join(run_dir, CSV))
    # a write the kill cut short: never counted, never re-scored
    open(os.path.join(run_dir, "5-adv.npy.tmp.npy"), "wb").close()
    on_disk = artifacts.list_adv_files(run_dir)
    assert 1 <= len(on_disk) <= 2 * BATCH and "5-adv.npy.tmp.npy" not in on_disk
    for f in on_disk:
        clip = np.load(os.path.join(run_dir, f))
        assert clip.dtype == np.float16 and clip.shape == (3, 8, 32, 32)
    rescored = str(tmp_path / "rescored")
    os.makedirs(rescored)
    for f in on_disk:
        shutil.copy(os.path.join(run_dir, f), rescored)

    b = _phase(run_dir, out_dir, "--resume")
    assert b.returncode == 0, b.stdout + b.stderr
    assert f"[e2e400:B] re-scored {len(on_disk)} artifacts" in b.stdout
    header, final = _report(run_dir)
    assert header == ["gt_label"] + [f"{m}-pre" for m in MODELS]
    assert sorted(final) == list(range(CLIPS))
    assert all(-1 not in preds for preds in final.values())
    assert len(artifacts.list_adv_files(run_dir)) == CLIPS
    with open(os.path.join(out_dir, "E2E_400_TORCH.json")) as f:
        summary = json.load(f)
    assert summary["phase_a"]["batches_completed"] == 2
    assert summary["phase_b"]["rescored_clips"] == len(on_disk)
    assert summary["labels_fully_covered"] == CLIPS == summary["report_rows"]

    # the re-scored labels: cli.evaluate's predictions over the same files
    evaluate.main(["--adv_path", rescored, "--tiny", "--device", "cpu", "--models", *MODELS,
                   "--batch_size", str(BATCH), "--n_classes", str(CLIPS)])
    _, offline = _report(rescored)
    for f in on_disk:
        lab = artifacts.label_of(f)
        assert offline[lab] == final[lab], lab


def test_the_tool_exits_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        tool.main(["--run_dir", str(tmp_path / "run"), "--out_dir", str(tmp_path / "out")])
    assert not os.listdir(tmp_path)
