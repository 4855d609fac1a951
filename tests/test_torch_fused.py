"""The port's fused generate→evaluate against the JAX package's, and the image
CLI's ``--fused_eval``.

An identity attack and the same tiny video models (JAX → port through
``from_jax_params``) go into both packages' ``FusedGenerateEvaluate``: the
predictions are the same, so both reports must be the same bytes — the CSV
and the JSON, whose top-1 both compute as a float64 mean of the hits. The
merged shard reports are held byte for byte against the JAX package's pandas
version.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.cli import image_main as jimage_main  # noqa: E402
from i2v_tpu.eval import fused as jfused  # noqa: E402
from i2v_tpu.models import video_zoo as jvideo_zoo  # noqa: E402
from i2v_tpu.models.api import VideoModel as JVideoModel  # noqa: E402
from i2v_tpu_torch.cli import evaluate, image_main, image_main_ucf101  # noqa: E402
from i2v_tpu_torch.eval import fused  # noqa: E402
from i2v_tpu_torch.models import VideoModel, video_zoo  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402
from i2v_tpu_torch.ops import kernels  # noqa: E402
from i2v_tpu_torch.utils import VIDEO_MODEL_NAMES, artifacts  # noqa: E402

MODELS = ("i3d_resnet50", "slowfast_resnet50")
N_CLASSES = 10
CLIP = (3, 8, 32, 32)
CSV, JSON = "results_all_models_prediction.csv", "top1_acc_all_models.json"


@pytest.fixture(scope="module")
def bundles():
    """({name: JAX bundle}, {name: port bundle}) with the same tiny weights."""
    jb, pb = {}, {}
    for seed, name in enumerate(MODELS):
        jmod = jvideo_zoo.TINY_BUILDERS[name]()
        params = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1,) + CLIP)))
        pmod = from_jax_params(video_zoo.TINY_BUILDERS[name](), params).eval()
        jb[name] = JVideoModel(name, jmod, jax.device_put(params))
        pb[name] = VideoModel(name, pmod.requires_grad_(False))
    return jb, pb


def _jattack(clips, labels, names=None):
    return jnp.asarray(clips)


def _attack(clips, labels, names=None):
    return torch.from_numpy(np.asarray(clips))


def _batches(seed, label_sets):
    rng = np.random.RandomState(seed)
    return [{"clips": rng.randn(len(labels), *CLIP).astype(np.float32),
             "labels": np.asarray(labels)} for labels in label_sets]


def _read(run_dir, sfx=""):
    with open(os.path.join(run_dir, f"results_all_models_prediction{sfx}.csv"), "rb") as f:
        csv_bytes = f.read()
    with open(os.path.join(run_dir, f"top1_acc_all_models{sfx}.json"), "rb") as f:
        return csv_bytes, f.read()


def _both(bundles, tmp_path, batches, *, shard=None):
    """Run both packages' fused evaluation over ``batches``; returns the two
    report directories and the two return values of ``finalize``."""
    jb, pb = bundles
    out = []
    for tag, cls, attack, models in (("jax", jfused.FusedGenerateEvaluate, _jattack, jb),
                                     ("port", fused.FusedGenerateEvaluate, _attack, pb)):
        d = str(tmp_path / tag)
        f = cls(attack, models, run_dir=None, n_classes=N_CLASSES)
        for b in batches:
            f.process_batch(b)
        out.append((d, f.finalize(report_dir=d, shard=shard), f))
    return out


def test_reports_are_the_jax_packages_bytes(bundles, tmp_path):
    batches = _batches(0, [[0, 3], [5, 9], [7]])
    (jdir, jacc, jf), (pdir, pacc, pf) = _both(bundles, tmp_path, batches)
    assert _read(pdir) == _read(jdir)
    assert pacc == jacc and list(pacc) == list(MODELS)
    assert pf.predictions == {k: [int(x) for x in v] for k, v in jf.predictions.items()}
    assert pf.labels_seen == [0, 3, 5, 9, 7]
    rows = _read(pdir)[0].decode().splitlines()
    assert len(rows) == N_CLASSES + 1 and rows[2] == "1,-1,-1"


def test_duplicate_labels_keep_the_last_as_in_jax(bundles, tmp_path):
    batches = _batches(1, [[1, 2], [2, 3]])
    with pytest.warns(UserWarning, match="duplicate labels"):
        (jdir, jacc, _), (pdir, pacc, pf) = _both(bundles, tmp_path, batches)
    assert _read(pdir) == _read(jdir) and pacc == jacc
    col = [int(r.split(",")[1]) for r in _read(pdir)[0].decode().splitlines()[1:]]
    assert col[2] == pf.predictions[MODELS[0]][2] and col[1] == pf.predictions[MODELS[0]][0]
    assert col[0] == -1


def test_shard_suffixed_reports_as_in_jax(bundles, tmp_path):
    (jdir, _, _), (pdir, _, _) = _both(bundles, tmp_path, _batches(2, [[0, 1]]), shard=3)
    assert _read(pdir, "_3") == _read(jdir, "_3")
    assert sorted(os.listdir(pdir)) == ["results_all_models_prediction_3.csv",
                                        "top1_acc_all_models_3.json"]


def test_resume_rescores_the_artifacts_on_disk(bundles, tmp_path):
    _, pb = bundles
    run_dir = str(tmp_path / "run")
    first, second = _batches(4, [[0, 1], [2, 3]])
    f1 = fused.FusedGenerateEvaluate(_attack, pb, run_dir=run_dir, n_classes=N_CLASSES)
    f1.process_batch(first)
    f1.writer.close()  # the artifacts are on disk; the process dies before finalize
    f2 = fused.FusedGenerateEvaluate(_attack, pb, run_dir=run_dir, n_classes=N_CLASSES)
    assert artifacts.existing_labels(run_dir) == {0, 1}
    f2.process_artifacts(artifacts.list_adv_files(run_dir))
    assert f2.predictions == f1.predictions and f2.labels_seen == [0, 1]
    f2.process_batch(second)
    f2.finalize()
    # the same reports as one uninterrupted run
    f3 = fused.FusedGenerateEvaluate(_attack, pb, run_dir=None, n_classes=N_CLASSES)
    for b in (first, second):
        f3.process_batch(b)
    f3.finalize(report_dir=str(tmp_path / "whole"))
    assert _read(run_dir) == _read(str(tmp_path / "whole"))
    assert artifacts.existing_labels(run_dir) == {0, 1, 2, 3}


def test_float16_artifacts_are_cast_before_the_copy(bundles, tmp_path, monkeypatch):
    seen = []
    submit = fused.AsyncArtifactWriter.submit

    def spy(self, labels, adv):
        seen.append(adv.dtype)
        return submit(self, labels, adv)

    monkeypatch.setattr(fused.AsyncArtifactWriter, "submit", spy)
    (b,) = _batches(3, [[4, 5]])
    f = fused.FusedGenerateEvaluate(_attack, bundles[1], run_dir=str(tmp_path),
                                    n_classes=N_CLASSES, artifact_dtype=np.float16)
    f.process_batch(b)
    f.finalize()
    assert seen == [torch.float16]
    adv = np.load(tmp_path / "4-adv.npy")
    assert adv.dtype == np.float16 and adv.shape == CLIP
    np.testing.assert_array_equal(adv, b["clips"][0].astype(np.float16))


def test_writer_errors_are_raised_at_submit_and_at_close(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")  # a file where the run directory should be
    w = fused.AsyncArtifactWriter(str(blocker / "run"))
    w.submit([0], torch.zeros(1, *CLIP))
    # the writer thread fails; the poll ends as soon as it has, and the long
    # deadline only covers a machine whose threads are starved
    deadline = time.time() + 60
    while not w._err and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="artifact writer failed"):
        w.submit([1], torch.zeros(1, *CLIP))
    with pytest.raises(RuntimeError, match="artifact writer failed"):
        w.close()
    assert not w._t.is_alive()


def test_merge_shard_reports_is_the_jax_packages_bytes(bundles, tmp_path):
    _, pb = bundles
    for d in ("jax", "port"):
        for shard, labels in ((1, [0, 1]), (2, [2, 3]), (10, [6])):
            f = fused.FusedGenerateEvaluate(_attack, pb, run_dir=None, n_classes=N_CLASSES)
            f.process_batch(_batches(shard, [labels])[0])
            f.finalize(report_dir=str(tmp_path / d), shard=shard)
    want = jfused.merge_shard_reports(str(tmp_path / "jax"))
    got = fused.merge_shard_reports(str(tmp_path / "port"))
    assert got == want
    assert _read(str(tmp_path / "port")) == _read(str(tmp_path / "jax"))
    rows = _read(str(tmp_path / "port"))[0].decode().splitlines()
    assert [r.split(",")[1] != "-1" for r in rows[1:]] == [i in (0, 1, 2, 3, 6)
                                                            for i in range(N_CLASSES)]
    # two shards that give one label different predictions
    p = tmp_path / "port" / "results_all_models_prediction_2.csv"
    lines = p.read_text().splitlines()
    first = lines[1].split(",")
    first[1] = str((int(rows[1].split(",")[1]) + 1) % N_CLASSES)
    p.write_text("\n".join([lines[0], ",".join(first)] + lines[2:]) + "\n")
    with pytest.raises(ValueError, match="disagree"):
        fused.merge_shard_reports(str(tmp_path / "port"))
    with pytest.raises(FileNotFoundError):
        fused.merge_shard_reports(str(tmp_path / "none"))


# -- the CLIs -----------------------------------------------------------------

@pytest.fixture
def opt_path(tmp_path, monkeypatch):
    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    return tmp_path


ENS = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--step", "2", "--tiny",
       "--n_synthetic", "2", "--clip_len", "4"]


def test_fused_eval_all_writes_what_evaluate_writes(opt_path):
    args = image_main.arg_parse(ENS + ["--fused_eval", "all", "--device", "cpu"])
    assert args.adv_path == jimage_main.arg_parse(ENS + ["--fused_eval", "all"]).adv_path
    kernels.reset_launches()
    run_dir = image_main.run(args)
    assert sorted(os.listdir(run_dir)) == ["0-adv.npy", "1-adv.npy", "loss_info_1.json", CSV,
                                           JSON]
    fused_csv, fused_json = _read(run_dir)
    assert list(json.loads(fused_json)) == list(VIDEO_MODEL_NAMES)
    assert args.throughput["clips"] == 2 and args.throughput["clips_per_sec"] > 0
    acc = evaluate.main(["--adv_path", run_dir, "--tiny", "--device", "cpu",
                         "--batch_size", "1"])
    assert _read(run_dir)[0] == fused_csv
    for name, top1 in json.loads(fused_json).items():
        assert abs(top1 - acc[name]) <= 1e-4


def test_fused_no_artifacts_shard_writes_only_suffixed_reports(opt_path):
    argv = ENS + ["--fused_eval", "i3d_resnet50", "--no_artifacts", "--artifact_dtype",
                  "float16", "--batch_nums", "2", "--batch_index", "1", "--device", "cpu"]
    run_dir = image_main.main(argv)
    assert sorted(os.listdir(run_dir)) == ["loss_info_1.json",
                                           "results_all_models_prediction_1.csv",
                                           "top1_acc_all_models_1.json"]
    rows = _read(run_dir, "_1")[0].decode().splitlines()
    assert rows[0] == "gt_label,i3d_resnet50-pre" and len(rows) == 401
    assert rows[1] != "0,-1" and rows[2] == "1,-1"   # shard 1 of 2 holds clip 0 only


def test_ucf101_cli_has_the_jax_clis_run_dir_and_101_report_rows(opt_path):
    argv = ["--attack_method", "AENS_I2V_MF", "--tiny", "--n_synthetic", "1",
            "--clip_len", "4", "--fused_eval", "tpn_resnet50"]
    want_dir = jimage_main.arg_parse(argv, kind="UCF101_Image", default_step=10).adv_path
    run_dir = image_main_ucf101.main(argv + ["--device", "cpu"])
    assert run_dir == want_dir
    assert os.path.basename(run_dir) == "UCF101_Image-AENS_I2V_MF-10-synthetic"
    assert sorted(os.listdir(run_dir)) == ["0-adv.npy", "loss_info_1.json", CSV, JSON]
    assert len(_read(run_dir)[0].decode().splitlines()) == 102


def test_unknown_fused_model_is_refused(opt_path):
    with pytest.raises(SystemExit, match="unknown video model"):
        image_main.main(ENS + ["--fused_eval", "c3d", "--device", "cpu"])
