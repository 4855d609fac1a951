"""The port's white-box attack CLI on the CPU: its run directory is the JAX
CLI's, it writes adv and ori artifacts, it resumes, and it refuses what is
not ported (naming the ROADMAP item) and a CUDA device without a card."""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from i2v_tpu.cli import attack as jattack_cli  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.cli import attack, common  # noqa: E402
from i2v_tpu_torch.data.synthetic import SyntheticAttackDataset  # noqa: E402
from i2v_tpu_torch.models import get_video_model  # noqa: E402
from i2v_tpu_torch.ops import pixel  # noqa: E402

EPS = 16 / 255
TINY = ["--tiny", "--data", "synthetic", "--n_synthetic", "2", "--device", "cpu"]


@pytest.fixture
def opt_path(tmp_path, monkeypatch):
    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("flags", [
    ["--attack_method", "BIM", "--step", "2"],
    ["--model", "i3d_resnet101", "--attack_method", "SIM", "--step", "3",
     "--file_prefix", "x"],
    ["--attack_method", "FGSM", "--data", "synthetic", "--file_prefix", "synthetic-y"],
])
def test_run_dir_is_the_jax_clis(opt_path, flags):
    assert attack.arg_parse(flags).adv_path == jattack_cli.arg_parse(flags).adv_path
    assert os.path.dirname(attack.arg_parse(flags).adv_path) == str(opt_path)


def test_bim_writes_adv_and_ori_and_resumes(opt_path, capsys):
    argv = ["--attack_method", "BIM", "--step", "2", "--file_prefix", "wb"] + TINY
    run_dir = attack.main(argv)
    assert os.path.basename(run_dir) == "i3d_resnet50-BIM-2-synthetic-wb"
    assert sorted(os.listdir(run_dir)) == ["0-adv.npy", "0-ori.npy", "1-adv.npy", "1-ori.npy"]
    ds = SyntheticAttackDataset(n_samples=2, clip_len=8, size=32)
    for label in (0, 1):
        adv = np.load(os.path.join(run_dir, f"{label}-adv.npy"))
        ori = np.load(os.path.join(run_dir, f"{label}-ori.npy"))
        assert adv.shape == ori.shape == (3, 8, 32, 32) and adv.dtype == np.float32
        np.testing.assert_array_equal(ori, ds[label][0])
        d = pixel.unnormalize(torch.from_numpy(adv), 0) - pixel.unnormalize(torch.from_numpy(ori), 0)
        assert 0 < float(d.abs().max()) <= EPS + 1e-5
    assert "Running BIM" in capsys.readouterr().out
    args = attack.arg_parse(argv)
    attack.run(args)
    assert "Running BIM" not in capsys.readouterr().out  # both pairs exist
    assert args.throughput["calls"] == 0
    # a label with only its adv artifact is attacked again
    os.remove(os.path.join(run_dir, "1-ori.npy"))
    args = attack.arg_parse(argv)
    attack.run(args)
    assert capsys.readouterr().out.count("Running BIM") == 1
    assert os.path.exists(os.path.join(run_dir, "1-ori.npy"))
    assert list(args.loss_info) == ["synthetic_1"] and len(args.loss_info["synthetic_1"]) == 2


@pytest.mark.parametrize("method", ["FGSM", "MIFGSM", "SGM", "SIM"])
def test_every_ported_method_runs(opt_path, method):
    argv = ["--attack_method", method, "--step", "2", "--batch_size", "2"] + TINY
    if method == "SIM":
        argv.append("--sim_batch_scales")
    args = attack.arg_parse(argv)
    run_dir = attack.run(args)
    assert len([f for f in os.listdir(run_dir) if f.endswith("-adv.npy")]) == 2
    steps = 1 if method == "FGSM" else 2
    assert all(len(v) == steps for v in args.loss_info.values())


def test_build_whitebox_attack_applies_the_flags():
    bundle = get_video_model("i3d_resnet50", device="cpu", tiny=True)
    args = attack.arg_parse(["--attack_method", "SIM", "--step", "4", "--batch_chunk", "2",
                             "--sim_batch_scales"])
    atk = common.build_whitebox_attack(args, bundle)
    assert isinstance(atk, attacks.SIM) and atk.batch_scales
    assert atk.cfg.batch_chunk == 2 and atk.steps == 4
    atk = common.build_whitebox_attack(attack.arg_parse(["--attack_method", "MIFGSM"]), bundle)
    assert atk.cfg.batch_chunk is None and atk.cfg.grad_norm == "frame"


@pytest.mark.parametrize("method", common.UNPORTED_WHITEBOX_METHODS)
def test_unported_methods_are_refused_with_the_roadmap_item(method, capsys):
    assert method in jattack_cli.common.WHITEBOX_METHODS
    with pytest.raises(SystemExit):
        attack.arg_parse(["--attack_method", method])
    assert "ROADMAP Queue 1" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        attack.arg_parse(["--attack_method", "NOPE"])


def test_unported_models_are_refused(opt_path):
    """All six reference models are ported; any other name is refused before
    an artifact is written."""
    with pytest.raises(ValueError, match="unknown video model"):
        attack.main(["--model", "c3d_resnet50", "--step", "1"] + TINY)
    assert not any(f.endswith(".npy") for _, _, fs in os.walk(opt_path) for f in fs)


@pytest.mark.parametrize("model", ["slowfast_resnet50", "tpn_resnet50"])
def test_bim_runs_on_slowfast_and_tpn(opt_path, model):
    args = attack.arg_parse(["--model", model, "--attack_method", "BIM", "--step", "3"] + TINY)
    run_dir = attack.run(args)
    assert os.path.basename(run_dir) == f"{model}-BIM-3-synthetic"
    ds = SyntheticAttackDataset(n_samples=2, clip_len=8, size=32)
    for label in (0, 1):
        adv = np.load(os.path.join(run_dir, f"{label}-adv.npy"))
        d = pixel.unnormalize(torch.from_numpy(adv), 0) - torch.from_numpy(ds.clip01(label))
        assert adv.shape == (3, 8, 32, 32) and 0 < float(d.abs().max()) <= EPS + 1e-5
    costs = {k: [float(c["cost"]) for c in v.values()] for k, v in args.loss_info.items()}
    assert sorted(costs) == ["synthetic_0", "synthetic_1"]
    assert all(len(c) == 3 and c[-1] > c[0] for c in costs.values())


def test_cuda_device_without_a_card_stops(opt_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        attack.main(["--step", "1", "--tiny", "--n_synthetic", "1"])
    assert not os.listdir(opt_path)


def test_resume_subset_drops_done_labels_before_decoding():
    class Manifest:
        samples = [types.SimpleNamespace(label=i) for i in (4, 7, 9)]

        def __getitem__(self, i):
            return ("clip", self.samples[i].label, f"v{i}", i)

        def __len__(self):
            return len(self.samples)

    ds = Manifest()
    view = common.resume_subset(ds, {7})
    assert len(view) == 2 and [view[i][1] for i in range(2)] == [4, 9]
    assert view.load_batch is None  # the batcher falls back to items
    assert common.resume_subset(ds, set()) is None
    assert common.resume_subset(ds, {1}) is None
    assert common.resume_subset(SyntheticAttackDataset(n_samples=2), {0}) is None


def test_save_attack_outputs_writes_ori_only_when_asked(tmp_path):
    clips = np.random.RandomState(0).rand(2, 3, 2, 4, 4).astype(np.float32)
    batch = {"clips": clips, "labels": np.asarray([3, 5])}
    common.save_attack_outputs(str(tmp_path / "a"), batch, torch.from_numpy(clips))
    common.save_attack_outputs(str(tmp_path / "b"), batch, torch.from_numpy(clips), save_ori=True)
    assert sorted(os.listdir(tmp_path / "a")) == ["3-adv.npy", "5-adv.npy"]
    assert sorted(os.listdir(tmp_path / "b")) == ["3-adv.npy", "3-ori.npy", "5-adv.npy",
                                                  "5-ori.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "b" / "5-ori.npy"), clips[1])
