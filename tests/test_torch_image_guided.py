"""The port's DR and AENS-I2V-MF against the JAX package, their losses, and
the image CLI that dispatches them.

The same weights (JAX → port through ``from_jax_params``) and the same numpy
clips go through both packages. Tolerances, as the JAX package holds itself
to its torch oracle (tests/test_i2v_parity.py:211-275):
  - the losses at random inputs, rtol 1e-5 (summation order alone);
  - the DR and AENS cost trajectories, rtol 3e-4 (Adam's first, quasi-sign
    steps amplify float32 differences);
  - AENS's per-step coefficients, atol 1e-5. They are a softmax of the
    previous step's per-tap cosine sums, so they follow the pixel
    trajectories' divergence with a gain: AENS runs ResNet's two taps, as the
    JAX package's own AENS test does, over 3 steps (at 5 steps the
    coefficients of two correct implementations part by up to 4e-5).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

import i2v_tpu.attacks as jattacks  # noqa: E402
from i2v_tpu.cli import image_main as jimage_main  # noqa: E402
from i2v_tpu.models import get_image_models as jget_image_models  # noqa: E402
from i2v_tpu.ops import losses as jlosses  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.cli import common, image_main  # noqa: E402
from i2v_tpu_torch.models import ImageModel, build_image_model, get_video_model  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402
from i2v_tpu_torch.ops import kernels, losses, pixel  # noqa: E402

EPS = 16 / 255
STEPS = 5
STEP_SIZE = 0.01
HW = 32
AENS_NAMES = ["resnet"]
AENS_STEPS = 3
AENS_DEPTHS = {n: [2, 3] for n in AENS_NAMES}


def _pair(names, depths):
    """Tiny JAX bundles and their port twins, sharing weights."""
    jbundles = jget_image_models(names, depths, tiny=True, input_hw=HW)
    ported = []
    for b in jbundles:
        d = depths if isinstance(depths, int) else depths[b.name]
        module, taps = build_image_model(b.name, d, tiny=True, input_hw=HW)
        from_jax_params(module, jax.tree_util.tree_map(np.asarray, b.params))
        ported.append(ImageModel(b.name, module.eval().requires_grad_(False), taps))
    return jbundles, ported


def _videos(seed):
    clips01 = np.random.RandomState(seed).rand(1, 3, 4, HW, HW).astype(np.float32)
    return clips01, np.asarray(jpixel.normalize(jnp.asarray(clips01), channel_axis=1))


def _costs(atk, name="v"):
    info = atk.loss_info[name]
    return [float(info[i]["cost"]) for i in range(len(info))]


def _check_invariants(adv_norm, clips01):
    adv01 = pixel.unnormalize(torch.as_tensor(adv_norm), channel_axis=1).numpy()
    assert adv01.shape == clips01.shape
    assert adv01.min() >= -1e-5 and adv01.max() <= 1 + 1e-5
    assert np.abs(adv01 - clips01).max() <= EPS + 1e-5


# -- losses -------------------------------------------------------------------

def _taps(rng, shapes, scale=1.0):
    return [(scale * rng.randn(*s)).astype(np.float32) for s in shapes]


TAP_SHAPES = [(4, 8, 6, 6), (4, 16, 3, 3)]


def test_dispersion_cost_matches_jax():
    taps = _taps(np.random.RandomState(0), TAP_SHAPES, scale=3.0)
    want = float(jlosses.dispersion_cost([jnp.asarray(t) for t in taps]))
    got = losses.dispersion_cost([torch.from_numpy(t) for t in taps])
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("at_clean", [False, True], ids=["random", "adv==clean"])
def test_ilaf_cost_and_directions_match_jax(at_clean):
    rng = np.random.RandomState(1)
    clean = _taps(rng, TAP_SHAPES)
    adv = [c + 0.1 * rng.randn(*c.shape).astype(np.float32) for c in clean]
    step = [c.copy() for c in clean] if at_clean else _taps(rng, TAP_SHAPES)
    jdirs, jnorms = jlosses.feature_delta_direction([jnp.asarray(a) for a in adv],
                                                    [jnp.asarray(c) for c in clean])
    dirs, norms = losses.feature_delta_direction([torch.from_numpy(a) for a in adv],
                                                 [torch.from_numpy(c) for c in clean])
    for d, jd, n, jn in zip(dirs, jdirs, norms, jnorms):
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-5)

    def jcost(*s):
        return jlosses.ilaf_cost(list(s), [jnp.asarray(c) for c in clean], jdirs, jnorms)

    jstep = [jnp.asarray(s) for s in step]
    want = float(jcost(*jstep))
    want_g = jax.grad(jcost, argnums=(0, 1))(*jstep)
    tstep = [torch.from_numpy(s).requires_grad_(True) for s in step]
    cost = losses.ilaf_cost(tstep, [torch.from_numpy(c) for c in clean], dirs, norms)
    cost.backward()
    assert np.isfinite(float(cost.detach()))
    np.testing.assert_allclose(float(cost.detach()), want, rtol=1e-5)
    for t, jg in zip(tstep, want_g):
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(np.asarray(jg)).max()))


def test_feature_delta_direction_is_finite_at_adv_equal_clean():
    clean = _taps(np.random.RandomState(2), TAP_SHAPES)
    dirs, norms = losses.feature_delta_direction([torch.from_numpy(c) for c in clean],
                                                 [torch.from_numpy(c) for c in clean])
    assert all(float(n) == 0.0 and not torch.isnan(d).any() for d, n in zip(dirs, norms))


def test_sign_keep_nan_keeps_nan_and_zero():
    g = torch.tensor([float("nan"), -2.0, 0.0, -0.0, 3.0])
    out = pixel.sign_keep_nan(g)
    assert torch.isnan(out[0]) and out[1:].tolist() == [-1.0, 0.0, 0.0, 1.0]


# -- DR and AENS against the JAX package -------------------------------------

def test_dr_matches_jax():
    jb, pb = _pair(["resnet"], 2)
    jatk = jattacks.ImageGuidedStd_Adam(jb, step_size=STEP_SIZE, epsilon=EPS, steps=STEPS)
    patk = attacks.ImageGuidedStd_Adam(pb, step_size=STEP_SIZE, epsilon=EPS, steps=STEPS)
    clips01, videos = _videos(5)
    jatk(jnp.asarray(videos), jnp.asarray([0]), video_names=["v"])
    kernels.reset_launches()
    adv = patk(videos, np.asarray([0]), video_names=["v"])
    assert kernels.launches == {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": 0, "bias_act": 0,
                                "window_attn": 0, "pool_attn": 0, "pool_qkv": 0, "dwconv3d": 0,
                                "global_attn": 0}
    np.testing.assert_allclose(_costs(patk), _costs(jatk), rtol=3e-4)
    assert _costs(patk)[-1] < _costs(patk)[0]
    _check_invariants(adv, clips01)
    assert str(patk).startswith("ImageGuidedStd_Adam(")


@pytest.fixture(scope="module")
def aens_pair():
    return _pair(AENS_NAMES, AENS_DEPTHS)


@pytest.mark.parametrize("momentum,coef_ce", [(0.0, False), (0.8, False), (0.5, True)])
def test_aens_matches_jax(aens_pair, momentum, coef_ce):
    jb, pb = aens_pair
    kw = dict(step_size=STEP_SIZE, momentum=momentum, coef_CE=coef_ce, epsilon=EPS,
              steps=AENS_STEPS)
    jatk, patk = jattacks.AENS_I2V_MF(jb, **kw), attacks.AENS_I2V_MF(pb, **kw)
    assert patk.n_taps == jatk.n_taps == 2
    clips01, videos = _videos(11)
    _, _, jcost = jatk(jnp.asarray(videos), jnp.asarray([0]), video_names=["v"])
    out = patk(videos, np.asarray([0]), video_names=["v"])
    assert isinstance(out, tuple) and len(out) == 3
    adv, used_time, cost_saved = out
    assert isinstance(adv, torch.Tensor) and used_time > 0
    assert isinstance(cost_saved, np.ndarray) and cost_saved.shape == (AENS_STEPS,)
    np.testing.assert_allclose(cost_saved, np.asarray(jcost), rtol=3e-4)
    np.testing.assert_allclose(np.stack(patk.weights), np.stack(jatk.weights), atol=1e-5)
    np.testing.assert_array_equal(np.float32(_costs(patk)), cost_saved)
    _check_invariants(adv, clips01)


def test_aens_coefficients_persist_across_calls_as_in_jax(aens_pair):
    jb, pb = aens_pair
    kw = dict(step_size=STEP_SIZE, momentum=0.8, epsilon=EPS, steps=AENS_STEPS)
    jatk, patk = jattacks.AENS_I2V_MF(jb, **kw), attacks.AENS_I2V_MF(pb, **kw)
    for seed in (3, 4):
        _, videos = _videos(seed)
        jatk(jnp.asarray(videos), jnp.asarray([0]))
        patk(videos, np.asarray([0]))
        np.testing.assert_allclose(np.stack(patk.weights), np.stack(jatk.weights), atol=1e-5)
        np.testing.assert_allclose(patk.coeffs.numpy(), np.asarray(jatk.coeffs), atol=1e-5)
    # the second call started from the first call's last coefficients
    assert not np.allclose(patk.weights[0], np.full(2, 0.5))


def test_aens_refuses_the_int_return_type(aens_pair):
    atk = attacks.AENS_I2V_MF(aens_pair[1], step_size=STEP_SIZE, steps=1)
    with pytest.raises(NotImplementedError, match="triple"):
        atk.set_return_type("int")
    atk.set_return_type("float")


def test_save_unwraps_aens_and_skips_accuracy_for_image_surrogates(aens_pair, tmp_path, capsys):
    _, videos = _videos(6)
    batches = [{"clips": np.concatenate([videos, videos]), "labels": np.asarray([0, 1])}]
    attacks.AENS_I2V_MF(aens_pair[1], step_size=STEP_SIZE, steps=2).save(
        str(tmp_path / "aens"), batches)
    assert sorted(os.listdir(tmp_path / "aens")) == ["0-adv.npy", "1-adv.npy"]
    a = np.load(tmp_path / "aens" / "0-adv.npy")
    assert a.dtype == np.float32 and a.shape == (3, 4, HW, HW)
    assert "Accuracy" not in capsys.readouterr().out


def test_save_of_an_int_attack_writes_normalized_clips(tmp_path, capsys):
    bundle = get_video_model("i3d_resnet50", device="cpu", tiny=True)
    clips01 = np.random.RandomState(0).rand(2, 3, 8, 32, 32).astype(np.float32)
    clips = pixel.normalize(torch.from_numpy(clips01), channel_axis=1).numpy()
    atk = attacks.BIM(bundle, steps=2)
    atk.set_return_type("int")
    atk.save(str(tmp_path), [{"clips": clips, "labels": np.asarray([3, 4])}])
    saved = np.load(tmp_path / "4-adv.npy")
    want = pixel.normalize(atk(clips, np.asarray([3, 4])).float() / 255, channel_axis=1)
    np.testing.assert_array_equal(saved, want[1].numpy())
    assert "Save Progress [1] Accuracy" in capsys.readouterr().out


# -- the CLI ------------------------------------------------------------------

@pytest.fixture
def opt_path(tmp_path, monkeypatch):
    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("flags", [
    ["--attack_method", "ImageGuidedStd_Adam", "--depth", "2", "--step", "2"],
    ["--attack_method", "AENS_I2V_MF", "--step", "2", "--aens_momentum", "0.5", "--coef_CE"],
])
def test_cli_writes_the_jax_clis_run_dir_and_artifacts(opt_path, flags):
    argv = flags + ["--tiny", "--data", "synthetic", "--n_synthetic", "2", "--clip_len", "4"]
    jdir = jimage_main.arg_parse(argv).adv_path
    args = image_main.arg_parse(argv + ["--device", "cpu"])
    kernels.reset_launches()
    run_dir = image_main.run(args)
    assert run_dir == jdir
    assert sorted(os.listdir(run_dir)) == ["0-adv.npy", "1-adv.npy", "loss_info_1.json"]
    assert np.load(os.path.join(run_dir, "0-adv.npy")).shape == (3, 4, 32, 32)
    with open(os.path.join(run_dir, "loss_info_1.json")) as f:
        info = json.load(f)
    assert sorted(info) == ["synthetic_0", "synthetic_1"]
    assert all(len(v) == 2 for v in info.values())
    assert args.throughput["calls"] == 2


def test_cli_builds_aens_with_the_jax_clis_taps_and_settings(opt_path):
    args = image_main.arg_parse(["--attack_method", "AENS_I2V_MF", "--tiny", "--step", "7",
                                 "--step_size", "0.002", "--aens_momentum", "0.3", "--coef_CE"])
    atk = common.build_image_guided_attack(args, torch.device("cpu"))
    jatk = jimage_main.common.build_image_guided_attack(jimage_main.arg_parse(
        ["--attack_method", "AENS_I2V_MF", "--tiny", "--step", "7", "--step_size", "0.002",
         "--aens_momentum", "0.3", "--coef_CE"]))
    assert type(atk).__name__ == type(jatk).__name__ == "AENS_I2V_MF"
    assert [m.name for m in atk.models] == [m.name for m in jatk.models]
    assert [tuple(m.tap_keys) for m in atk.models] == [tuple(m.tap_keys) for m in jatk.models]
    assert (atk.steps, atk.step_size, atk.momentum, atk.coef_CE, atk.n_taps) == \
        (jatk.steps, jatk.step_size, jatk.momentum, jatk.coef_CE, jatk.n_taps) == \
        (7, 0.002, 0.3, True, 8)
