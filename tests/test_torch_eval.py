"""The port's transfer evaluation against the JAX package's, and its CLIs.

The same artifact directory goes through ``i2v_tpu.eval.evaluate_run`` and
the port's, with the same tiny weights (JAX → port through
``from_jax_params``) handed to both by ``get_bundle``: the predictions and
``results_all_models_prediction.csv`` must be identical byte for byte and
the top-1 values within 1e-6 (both are float32 means of the same hits). The
JAX modules are initialised once a module; the CLI tests run on artifacts
the port's ``image_main`` writes, on the CPU.
"""

import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.eval import transfer as jtransfer  # noqa: E402
from i2v_tpu.models import video_zoo as jvideo_zoo  # noqa: E402
from i2v_tpu.models.api import VideoModel as JVideoModel  # noqa: E402
from i2v_tpu_torch.cli import evaluate, evaluate_ucf101, image_main  # noqa: E402
from i2v_tpu_torch.data.pipeline import threaded_prefetch  # noqa: E402
from i2v_tpu_torch.eval import transfer  # noqa: E402
from i2v_tpu_torch.models import VideoModel, get_video_model, video_zoo  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402
from i2v_tpu_torch.utils import VIDEO_MODEL_NAMES  # noqa: E402

MODELS = ("i3d_resnet50", "slowfast_resnet50", "tpn_resnet50")
LABELS = (0, 2, 3, 5, 9)   # batch_size 2: two full batches and a partial one
N_CLASSES = 10
CSV, JSON = "results_all_models_prediction.csv", "top1_acc_all_models.json"


@pytest.fixture(scope="module")
def bundles():
    """{name: (JAX bundle, port bundle)} with the same tiny weights."""
    out = {}
    for seed, name in enumerate(MODELS):
        jmod = jvideo_zoo.TINY_BUILDERS[name]()
        params = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, 3, 8, 32, 32))))
        pmod = from_jax_params(video_zoo.TINY_BUILDERS[name](), params).eval()
        out[name] = (JVideoModel(name, jmod, jax.device_put(params)),
                     VideoModel(name, pmod.requires_grad_(False)))
    return out


@pytest.fixture(scope="module")
def artifacts_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("run")
    rng = np.random.RandomState(0)
    for label in LABELS:
        np.save(d / f"{label}-adv.npy", rng.randn(3, 8, 32, 32).astype(np.float32))
    return d


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _read(run_dir):
    with open(os.path.join(run_dir, CSV), "rb") as f:
        csv_bytes = f.read()
    with open(os.path.join(run_dir, JSON)) as f:
        return csv_bytes, json.load(f)


def _port_eval(run_dir, bundles, **kw):
    return transfer.evaluate_run(run_dir, model_names=MODELS, batch_size=2, n_classes=N_CLASSES,
                                 get_bundle=lambda n: bundles[n][1], device="cpu",
                                 log=lambda *_: None, **kw)


def test_reports_match_the_jax_package(bundles, artifacts_dir, tmp_path):
    jdir, pdir = _copy(artifacts_dir, tmp_path / "jax"), _copy(artifacts_dir, tmp_path / "port")
    want = jtransfer.evaluate_run(jdir, model_names=MODELS, batch_size=2, n_classes=N_CLASSES,
                                  get_bundle=lambda n: bundles[n][0], log=lambda *_: None)
    got = _port_eval(pdir, bundles)
    (jcsv, jjson), (pcsv, pjson) = _read(jdir), _read(pdir)
    assert pcsv == jcsv
    assert list(pjson) == list(jjson) == list(got) == list(want) == list(MODELS)
    for name in MODELS:
        assert abs(pjson[name] - jjson[name]) <= 1e-6 and abs(got[name] - want[name]) <= 1e-6
    rows = pcsv.decode().splitlines()
    assert rows[0] == "gt_label," + ",".join(f"{m}-pre" for m in MODELS)
    assert len(rows) == N_CLASSES + 1
    for label in range(N_CLASSES):
        cells = rows[label + 1].split(",")
        assert cells[0] == str(label)
        assert (all(c != "-1" for c in cells[1:]) if label in LABELS
                else cells[1:] == ["-1"] * len(MODELS))


def test_serial_and_single_pass_reports_are_identical(bundles, artifacts_dir, tmp_path):
    serial, single = _copy(artifacts_dir, tmp_path / "a"), _copy(artifacts_dir, tmp_path / "b")
    tp_serial, tp_single = {}, {}
    assert _port_eval(serial, bundles, throughput=tp_serial) == \
        _port_eval(single, bundles, single_pass=True, throughput=tp_single)
    assert _read(serial) == _read(single)
    assert sorted(tp_serial) == sorted(MODELS) and list(tp_single) == ["single_pass"]
    assert all(v["clips"] == len(LABELS) and v["clips_per_sec"] > 0
               for v in list(tp_serial.values()) + list(tp_single.values()))


def test_accuracy_and_preds_match_the_jax_package():
    logits = np.random.RandomState(1).randn(7, N_CLASSES).astype(np.float32)
    labels = np.asarray([0, 3, 3, 9, 1, 2, 4])
    labels[2] = int(np.argmax(logits[2]))
    want_acc, want_preds = jtransfer.accuracy_and_preds(jnp.asarray(logits), jnp.asarray(labels))
    acc, preds = transfer.accuracy_and_preds(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(want_preds))
    assert acc.dtype == torch.float32 and float(acc) == float(want_acc) > 0


def test_order_predictions_by_label_fills_absent_labels_and_raises_on_bad_ones():
    np.testing.assert_array_equal(transfer.order_predictions_by_label([3, 0], [7, 1], 5),
                                  [1, -1, -1, 7, -1])
    np.testing.assert_array_equal(transfer.order_predictions_by_label([3, 0], [7, 1], 5),
                                  jtransfer.order_predictions_by_label([3, 0], [7, 1], 5))
    with pytest.raises(ValueError, match="outside"):
        transfer.order_predictions_by_label([5], [0], 5)
    with pytest.raises(ValueError, match="duplicate"):
        transfer.order_predictions_by_label([1, 1], [0, 2], 5)


def test_report_bytes_are_what_pandas_writes(tmp_path):
    import pandas as pd

    rng = np.random.RandomState(2)
    columns = {name: transfer.order_predictions_by_label(
        rng.permutation(400)[:7], rng.randint(0, 400, 7), 400) for name in VIDEO_MODEL_NAMES}
    acc = {name: float(rng.rand() * 100) for name in VIDEO_MODEL_NAMES}
    transfer.write_reports(str(tmp_path), columns, 400, acc)
    info = pd.DataFrame()
    info["gt_label"] = list(range(400))
    for name, col in columns.items():
        info[f"{name}-pre"] = col
    info.to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / CSV).read_bytes() == (tmp_path / "pandas.csv").read_bytes()
    assert (tmp_path / JSON).read_text() == json.dumps(acc)


def test_evaluate_run_refuses_data_parallel_and_empty_runs(tmp_path, monkeypatch):
    """Data-parallel evaluation is ported (tests/test_torch_mesh.py holds its
    reports): it is refused only where it would need a card and finds none,
    rather than carrying on on the CPU. An empty run is refused."""
    with pytest.raises(FileNotFoundError):
        transfer.evaluate_run(str(tmp_path), data_parallel=True, device="cpu")
    with pytest.raises(FileNotFoundError):
        transfer.evaluate_run(str(tmp_path), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transfer.evaluate_run(str(tmp_path), data_parallel=True)


@pytest.fixture
def opt_path(tmp_path, monkeypatch):
    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    return tmp_path


@pytest.fixture
def tf32_flags_restored(monkeypatch):
    """``--matmul_precision`` sets torch's process-wide TF32 flags; they are
    put back after the test."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)


def test_cli_evaluates_a_tiny_generation_run_on_the_cpu(opt_path, capsys, tf32_flags_restored):
    run_dir = image_main.main(["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--tiny",
                               "--n_synthetic", "2", "--step", "2", "--device", "cpu"])
    # a bare run name resolves under I2V_TPU_OPT_PATH
    args = evaluate.arg_parse(["--adv_path", os.path.basename(run_dir), "--tiny",
                               "--device", "cpu", "--matmul_precision", "float32"])
    assert args.adv_path == run_dir
    acc = evaluate.run(args)
    out = capsys.readouterr().out
    assert "[precision] float32" in out and "[summary] i3d_resnet50:" in out
    assert sorted(acc) == sorted(args.throughput) == sorted(VIDEO_MODEL_NAMES)
    csv_bytes, top1 = _read(run_dir)
    rows = csv_bytes.decode().splitlines()
    assert len(rows) == 401 and rows[0].count("-pre") == 6
    assert all(r.endswith(",-1,-1,-1,-1,-1,-1") for r in rows[3:])
    assert all("-1" not in r.split(",")[1:] for r in rows[1:3])
    assert top1 == acc


def test_ucf101_cli_writes_101_rows(opt_path):
    run_dir = opt_path / "run"
    run_dir.mkdir()
    np.save(run_dir / "100-adv.npy", np.zeros((3, 8, 32, 32), np.float32))
    acc = evaluate_ucf101.main(["--adv_path", str(run_dir), "--tiny", "--device", "cpu",
                                "--models", "tpn_resnet50"])
    rows = (run_dir / CSV).read_text().splitlines()
    assert list(acc) == ["tpn_resnet50"] and len(rows) == 102
    assert rows[101].startswith("100,") and rows[101] != "100,-1"


def test_cuda_device_without_a_card_stops(opt_path, monkeypatch):
    (opt_path / "0-adv.npy").write_bytes(b"")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        evaluate.main(["--adv_path", str(opt_path), "--tiny"])
    assert not (opt_path / CSV).exists()


@pytest.mark.parametrize("flag,item", [("--bf16", "item 10"), ("--data_parallel", "item 9")])
def test_cli_refuses_unported_flags_naming_the_roadmap_item(opt_path, capsys, flag, item):
    """No flag of the JAX CLI is refused any more. --bf16 (item 10) builds the
    models in bfloat16 (tests/test_torch_bf16.py holds the reports to the
    JAX CLI's); --data_parallel (item 9) cuts each batch over the mesh
    (tests/test_torch_mesh.py): both parse, naming no ROADMAP item."""
    args = evaluate.arg_parse(["--adv_path", str(opt_path), flag])
    assert getattr(args, flag[2:]) is True
    assert "ROADMAP" not in capsys.readouterr().err


def test_ucf101_models_have_101_classes_at_full_width():
    with pytest.warns(UserWarning, match="random init"):
        bundle = get_video_model("slowfast_resnet50", device="cpu", ucf101=True)
    assert bundle.module.fc.out_features == 101


def test_prefetch_reraises_worker_errors_and_stops_when_abandoned():
    def failing():
        yield 1
        raise RuntimeError("disk")

    it = threaded_prefetch(failing)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="disk"):
        next(it)

    produced = []

    def endless():
        for i in range(10**6):
            produced.append(i)
            yield i

    before = set(threading.enumerate())
    it = threaded_prefetch(endless)
    assert next(it) == 0
    # the prefetch worker itself, not a thread count that other threads of
    # the process (an earlier test's, winding down) also move
    (worker,) = set(threading.enumerate()) - before
    it.close()   # the consumer stops early
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert len(produced) < 10
