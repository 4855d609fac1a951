"""The port's white-box attack CLIs on the CPU: their run directories, flags
and defaults are the JAX CLIs', all ten methods run, they write adv and ori
artifacts, resume, and refuse an unknown method or model and a CUDA device
without a card."""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.cli import attack as jattack_cli  # noqa: E402
from i2v_tpu.cli import attack_ucf101 as jattack_ucf101_cli  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.cli import attack, attack_ucf101, common  # noqa: E402
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


@pytest.mark.parametrize("method", ["DIFGSM", "TIFGSM", "TIFGSM3D", "TAP", "TemporalTranslation"])
def test_methods_refused_before_are_accepted_and_run(opt_path, method, capsys):
    """The five methods the CLI refused before this slice run one tiny step
    and write the JAX CLI's run directory; an unknown name is refused."""
    flags = ["--attack_method", method, "--step", "1", "--kernlen", "3"]
    args = attack.arg_parse(flags + TINY)
    assert args.adv_path == jattack_cli.arg_parse(flags + TINY[:-2]).adv_path
    run_dir = attack.run(args)
    assert sorted(os.listdir(run_dir)) == ["0-adv.npy", "0-ori.npy", "1-adv.npy", "1-ori.npy"]
    assert all(len(v) == 1 for v in args.loss_info.values()) and len(args.loss_info) == 2
    if method == "TAP":
        assert set(args.loss_info["synthetic_0"][0]) == {"cost", "ce loss", "reg_cost",
                                                         "distance"}
    assert "not ported" not in capsys.readouterr().err
    with pytest.raises(SystemExit):
        attack.arg_parse(["--attack_method", "NOPE"])


def test_the_clis_accept_the_jax_clis_ten_methods_and_defaults():
    assert common.WHITEBOX_METHODS == jattack_cli.common.WHITEBOX_METHODS
    assert len(common.WHITEBOX_METHODS) == 10
    assert all(hasattr(attacks, m) for m in common.WHITEBOX_METHODS)
    for port_cli, jax_cli in ((attack, jattack_cli), (attack_ucf101, jattack_ucf101_cli)):
        ucf = {"ucf101": True} if port_cli is attack_ucf101 else {}
        mine = vars(attack.arg_parse([], **ucf))
        theirs = vars(jax_cli.arg_parse([]))
        for key in ("kernlen", "momentum", "augmentation_weight", "move_type", "kernel_mode",
                    "remat", "tt_chunk", "sim_batch_scales", "step", "attack_method", "model"):
            assert mine[key] == theirs[key], key


def test_tt_flags_reach_the_attack():
    bundle = get_video_model("i3d_resnet50", device="cpu", tiny=True)
    args = attack.arg_parse(["--attack_method", "TemporalTranslation", "--kernlen", "7",
                             "--momentum", "1", "--augmentation_weight", "0.25", "--move_type",
                             "random", "--kernel_mode", "linear", "--tt_chunk", "3",
                             "--step", "4"])
    atk = common.build_whitebox_attack(args, bundle)
    assert isinstance(atk, attacks.TemporalTranslation)
    assert (atk.kernlen, atk.momentum, atk.weight, atk.move_type, atk.kernel_mode, atk.chunk,
            atk.steps) == (7, True, 0.25, "random", "linear", 3, 4)
    assert atk.moves == tuple(range(-3, 4))
    atk = common.build_whitebox_attack(attack.arg_parse(["--attack_method", "TAP"]), bundle)
    assert (atk.kernlen, atk.temporal_kernlen, atk.eta, atk.conv3d, atk.feat_coef) == \
        (3, 3, 1e3, True, 0.05)


@pytest.mark.parametrize("method", ["TAP", "TemporalTranslation"])
def test_batch_chunk_on_tap_and_tt_warns_and_is_ignored(method, capsys):
    bundle = get_video_model("i3d_resnet50", device="cpu", tiny=True)
    atk = common.build_whitebox_attack(
        attack.arg_parse(["--attack_method", method, "--batch_chunk", "2"]), bundle)
    assert not hasattr(atk, "cfg")
    assert (f"[warn] --batch_chunk 2 is not supported by {method} and was ignored"
            in capsys.readouterr().out)
    atk = common.build_whitebox_attack(
        attack.arg_parse(["--attack_method", "DIFGSM", "--batch_chunk", "2"]), bundle)
    assert atk.cfg.batch_chunk == 2 and "[warn]" not in capsys.readouterr().out


def test_remat_reaches_the_video_model(opt_path, monkeypatch):
    built = {}
    real = attack.get_video_model

    def recording(name, **kw):
        built.update(kw)
        return real(name, **kw)

    monkeypatch.setattr(attack, "get_video_model", recording)
    attack.main(["--step", "1", "--remat", "--tiny", "--n_synthetic", "1", "--device", "cpu"])
    assert built["remat"] is True and built["ucf101"] is False


def test_attack_ucf101_writes_the_jax_clis_run_dir_with_101_class_heads(opt_path, monkeypatch):
    flags = ["--attack_method", "BIM", "--step", "2", "--file_prefix", "u"]
    assert attack_ucf101.main.__module__ == "i2v_tpu_torch.cli.attack_ucf101"
    assert attack.arg_parse(flags, ucf101=True).adv_path == \
        jattack_ucf101_cli.arg_parse(flags).adv_path
    built = {}
    real = attack.get_video_model

    def recording(name, **kw):
        built.update(kw)
        return real(name, **kw)

    monkeypatch.setattr(attack, "get_video_model", recording)
    run_dir = attack_ucf101.main(flags + TINY)
    assert os.path.basename(run_dir) == "UCF101_Video_i3d_resnet50-BIM-2-synthetic-u"
    assert sorted(os.listdir(run_dir)) == ["0-adv.npy", "0-ori.npy", "1-adv.npy", "1-ori.npy"]
    assert built["ucf101"] is True
    # the full-width bundle the flag selects has the 101-class head
    assert get_video_model("tpn_resnet50", device="cpu", ucf101=True).module.fc.out_features == 101


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


def test_kinetics_u8_ingress_writes_the_f32_paths_ori_and_adv(opt_path, monkeypatch):
    """BIM from Kinetics sidecars: with --u8_ingress --prefetch 1 the -ori
    and -adv artifacts are the float32 path's, byte for byte, and the -ori
    is the host transform of the sidecar's frames."""
    from i2v_tpu_torch.data import transforms

    rows = ["path,gt_label,clip_index"]
    frames = {}
    for v in range(2):
        frames[v] = np.random.RandomState(40 + v).randint(0, 256, (10, 256, 340, 3), np.uint8)
        np.save(opt_path / f"vid{v}.npy", frames[v])
        rows.append(f"vid{v}.npy,{v},{3 * v - 1}")
    (opt_path / "anno.csv").write_text("\n".join(rows) + "\n")
    monkeypatch.setenv("I2V_TPU_KINETICS_ANNO", str(opt_path / "anno.csv"))
    monkeypatch.setenv("I2V_TPU_KINETICS_DATA", str(opt_path))
    argv = ["--attack_method", "BIM", "--step", "2", "--tiny", "--data", "kinetics",
            "--clip_len", "4", "--crop_size", "32", "--device", "cpu", "--batch_size", "2"]
    u8dir = attack.main(argv + ["--u8_ingress", "--prefetch", "1"])
    f32dir = attack.main(argv + ["--file_prefix", "f32"])
    assert os.path.basename(u8dir) == "i3d_resnet50-BIM-2-"
    for label in (0, 1):
        for kind in ("adv", "ori"):
            got = np.load(os.path.join(u8dir, f"{label}-{kind}.npy"))
            np.testing.assert_array_equal(got, np.load(os.path.join(f32dir, f"{label}-{kind}.npy")))
        idx = transforms.kinetics_clip_indices(10, 3 * label - 1, 4)
        want = transforms.kinetics_val_transform(frames[label][idx], 256, 32)
        np.testing.assert_array_equal(np.load(os.path.join(u8dir, f"{label}-ori.npy")), want)


def test_ucf101_clis_read_frame_jpegs_for_data_kinetics(opt_path, monkeypatch):
    """The UCF-101 CLIs read ``--data kinetics`` as ``ucf101``, as the JAX
    CLIs do: BIM over Pillow-written frame JPEGs, the -ori the host
    transform of those frames."""
    from PIL import Image

    from i2v_tpu_torch.cli import image_main, image_main_ucf101
    from i2v_tpu_torch.data import ucf101

    for c in range(2):
        d = opt_path / "frames" / f"v_C{c}_g01_c01"
        d.mkdir(parents=True)
        for i in range(1, 7):
            Image.fromarray(np.random.RandomState(10 * c + i).randint(0, 256, (40, 52, 3), np.uint8)
                            ).save(str(d / f"image_{i:05d}.jpg"))
    (opt_path / "setting.txt").write_text("v_C0_g01_c01 6 4\nv_C1_g01_c01 9 7\n")
    monkeypatch.setenv("I2V_TPU_UCF_SETTING", str(opt_path / "setting.txt"))
    monkeypatch.setenv("I2V_TPU_UCF_IMAGE_ROOT", str(opt_path / "frames"))
    monkeypatch.setenv("I2V_TPU_UCF_USED_IDXS", str(opt_path / "absent.pkl"))
    argv = ["--attack_method", "BIM", "--step", "2", "--tiny", "--data", "kinetics",
            "--clip_len", "4", "--crop_size", "32", "--device", "cpu", "--u8_ingress"]
    run_dir = attack_ucf101.main(argv)
    assert os.path.basename(run_dir) == "UCF101_Video_i3d_resnet50-BIM-2-"
    ds = ucf101.UCF101AttackDataset(str(opt_path / "setting.txt"), str(opt_path / "frames"),
                                    clip_len=4, crop_size=32)
    for i, label in enumerate((4, 7)):
        np.testing.assert_array_equal(np.load(os.path.join(run_dir, f"{label}-ori.npy")),
                                      ds[i][0])
    seen = {}
    monkeypatch.setattr(image_main, "run", lambda args: seen.setdefault("data", args.data))
    image_main_ucf101.main(["--data", "kinetics", "--tiny"])
    assert seen["data"] == "ucf101"
