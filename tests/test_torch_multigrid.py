"""The port's multigrid schedule (``i2v_tpu_torch.parallel.multigrid``)
against the JAX package's, and the image CLI's runner flags (``--sharded``,
``--frame_chunk``, ``--param_dtype``, ``--multigrid``) against the JAX CLI's.

Tolerances: the area mean and the block repeat within 1e-7 (the mean's four
terms may be summed in another order); the multigrid costs within rtol 1e-5
at the same weights (JAX → port through ``from_jax_params``); the CLI's
refusals word for word.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.cli import image_main as jimage_main  # noqa: E402
from i2v_tpu.models import get_image_models as jget_image_models  # noqa: E402
from i2v_tpu.parallel import attack_mesh  # noqa: E402
from i2v_tpu.parallel import multigrid as jmultigrid  # noqa: E402
from i2v_tpu_torch.cli import common, image_main, image_main_ucf101  # noqa: E402
from i2v_tpu_torch.models import ImageModel, build_image_model  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params, modifier_from_jax  # noqa: E402
from i2v_tpu_torch.parallel import ShardedImageGuidedAttack, multigrid  # noqa: E402

EPS = 16 / 255
HW = 64                  # the coarse phase at scale 2 runs the tiny surrogates at 32²
STEPS, COARSE = 4, 2
CSV, JSON = "results_all_models_prediction.csv", "top1_acc_all_models.json"


def _pair():
    jbundles = jget_image_models(["resnet"], {"resnet": 2}, tiny=True, input_hw=HW)
    module, taps = build_image_model("resnet", 2, tiny=True, input_hw=HW)
    from_jax_params(module, jax.tree_util.tree_map(np.asarray, jbundles[0].params))
    return jbundles, [ImageModel("resnet", module.eval().requires_grad_(False), taps)]


@pytest.mark.parametrize("scale", [2, 4])
def test_downsample_and_upsample_match_jax(scale):
    rng = np.random.RandomState(scale)
    clips = rng.rand(2, 3, 4, 8, 8).astype(np.float32)
    want = np.asarray(jmultigrid.downsample_clips(jnp.asarray(clips), scale))
    got = multigrid.downsample_clips(torch.from_numpy(clips), scale).numpy()
    assert got.shape == (2, 3, 4, 8 // scale, 8 // scale)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    mod = rng.randn(6, 8 // scale, 8 // scale, 3).astype(np.float32)       # JAX layout
    want_up = np.asarray(jmultigrid.upsample_modifier(jnp.asarray(mod), scale))
    got_up = multigrid.upsample_modifier(modifier_from_jax(mod), scale)
    assert got_up.shape == (6, 3, 8, 8)
    np.testing.assert_allclose(got_up.numpy().transpose(0, 2, 3, 1), want_up, atol=1e-7, rtol=0)


def test_downsample_refuses_a_scale_that_does_not_divide():
    clips = np.zeros((1, 3, 2, 6, 6), np.float32)
    with pytest.raises(ValueError) as jerr:
        jmultigrid.downsample_clips(jnp.asarray(clips), 4)
    with pytest.raises(ValueError) as err:
        multigrid.downsample_clips(torch.from_numpy(clips), 4)
    assert str(err.value) == str(jerr.value)


def test_multigrid_runner_matches_jax():
    jb, pb = _pair()
    clean = np.random.RandomState(0).rand(1, 3, 4, HW, HW).astype(np.float32)
    kw = dict(steps=STEPS, coarse_steps=COARSE, frame_chunk=2)
    _, want = jmultigrid.make_multigrid_i2v_runner(jb, attack_mesh(jax.devices()[:1]), **kw)(
        jnp.asarray(clean))
    adv, costs = multigrid.make_multigrid_i2v_runner(pb, **kw)(torch.from_numpy(clean))
    assert costs.shape == (STEPS,)
    np.testing.assert_allclose(costs.numpy(), np.asarray(want), rtol=1e-5)
    a = adv.numpy()
    assert a.shape == clean.shape and a.min() >= 0 and a.max() <= 1
    assert np.abs(a - clean).max() <= np.float32(EPS) + 1e-6
    # the fine phase starts from the coarse modifier, not from the flat start
    assert costs[COARSE] < costs[0]


@pytest.mark.parametrize("kw", [dict(coarse_steps=0), dict(coarse_steps=STEPS),
                                dict(coarse_steps=1, scale=1)],
                         ids=["no-coarse-step", "no-fine-step", "scale-1"])
def test_multigrid_refuses_what_the_jax_runner_refuses(kw):
    with pytest.raises(ValueError) as jerr:
        jmultigrid.make_multigrid_i2v_runner([], None, steps=STEPS, **kw)
    with pytest.raises(ValueError) as err:
        multigrid.make_multigrid_i2v_runner([], steps=STEPS, **kw)
    assert str(err.value) == str(jerr.value)


# -- the CLI -------------------------------------------------------------------------

@pytest.fixture
def opt_path(tmp_path, monkeypatch):
    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("flags", [
    ["--multigrid", "2"],
    ["--attack_method", "AENS_I2V_MF", "--sharded", "--multigrid", "2"],
    ["--attack_method", "ImageGuidedStd_Adam", "--sharded", "--multigrid", "2"],
    ["--sharded", "--multigrid", "4"],
    ["--sharded", "--multigrid", "2", "--multigrid_scale", "3"],
    ["--sharded", "--multigrid", "2", "--multigrid_scale", "1"],
    ["--attack_method", "ImageGuidedStd_Adam", "--sharded"],
], ids=["multigrid-without-sharded", "multigrid-aens", "multigrid-dr", "K-not-below-step",
        "scale-does-not-divide", "scale-below-2", "sharded-dr"])
def test_cli_refuses_what_the_jax_cli_refuses(opt_path, flags):
    argv = ["--tiny", "--step", "4"] + flags
    with pytest.raises(SystemExit) as jerr:
        jimage_main.common.build_image_guided_attack(jimage_main.arg_parse(argv))
    with pytest.raises(SystemExit) as err:
        common.build_image_guided_attack(image_main.arg_parse(argv + ["--device", "cpu"]),
                                         torch.device("cpu"))
    assert str(err.value) == str(jerr.value) and str(err.value)


def test_frame_chunk_takes_an_int_or_auto(opt_path, capsys):
    for value, want in (("auto", "auto"), ("16", 16)):
        assert image_main.arg_parse(["--frame_chunk", value]).frame_chunk == want
        assert jimage_main.arg_parse(["--frame_chunk", value]).frame_chunk == want
    with pytest.raises(SystemExit):
        image_main.arg_parse(["--frame_chunk", "half"])
    assert "expected an integer or 'auto', got 'half'" in capsys.readouterr().err


TINY = ["--tiny", "--n_synthetic", "2", "--clip_len", "4", "--step", "2"]


@pytest.mark.parametrize("flags,run_dir", [
    (["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--sharded", "--frame_chunk", "4"],
     "Image-ImageGuidedFML2_Adam_MultiModels-2-synthetic"),
    (["--attack_method", "ImageGuidedFMDirection_Adam", "--depth", "2", "--sharded",
      "--multigrid", "1", "--crop_size", "64", "--param_dtype", "bfloat16"],
     "Image-ImageGuidedFMDirection_Adam-2-synthetic"),
], ids=["ens-chunk4", "i2v-multigrid-bf16"])
def test_sharded_cli_writes_the_jax_clis_run_dir_and_artifacts(opt_path, flags, run_dir):
    argv = flags + TINY
    args = image_main.arg_parse(argv + ["--device", "cpu"])
    assert args.adv_path == jimage_main.arg_parse(argv).adv_path
    assert os.path.basename(args.adv_path) == run_dir
    built = {}
    build = common.build_image_guided_attack

    def capture(*a):
        built["attack"] = build(*a)
        return built["attack"]

    common.build_image_guided_attack = capture
    try:
        image_main.run(args)
    finally:
        common.build_image_guided_attack = build
    assert isinstance(built["attack"], ShardedImageGuidedAttack)
    assert sorted(os.listdir(args.adv_path)) == ["0-adv.npy", "1-adv.npy", "loss_info_1.json"]
    crop = 64 if "--crop_size" in flags else 32
    assert np.load(os.path.join(args.adv_path, "0-adv.npy")).shape == (3, 4, crop, crop)
    with open(os.path.join(args.adv_path, "loss_info_1.json")) as f:
        info = json.load(f)
    assert sorted(info) == ["synthetic_0", "synthetic_1"]
    assert all(len(v) == 2 for v in info.values())


def test_sharded_aens_fused_eval_writes_the_reports_in_float16(opt_path):
    argv = ["--attack_method", "AENS_I2V_MF", "--aens_momentum", "0.5", "--coef_CE",
            "--sharded", "--frame_chunk", "auto", "--fused_eval", "i3d_resnet50",
            "--artifact_dtype", "float16", "--tiny", "--n_synthetic", "2", "--clip_len", "4",
            "--batch_size", "2", "--step", "2"]
    run_dir = image_main_ucf101.main(argv + ["--device", "cpu"])
    assert run_dir == jimage_main.arg_parse(argv, kind="UCF101_Image", default_step=10).adv_path
    assert sorted(os.listdir(run_dir)) == ["0-adv.npy", "1-adv.npy", "loss_info_1.json", CSV,
                                           JSON]
    assert np.load(os.path.join(run_dir, "1-adv.npy")).dtype == np.float16
    with open(os.path.join(run_dir, CSV)) as f:
        rows = f.read().splitlines()
    assert rows[0] == "gt_label,i3d_resnet50-pre" and len(rows) == 102
    assert rows[1] != "0,-1" and rows[2] != "1,-1"
