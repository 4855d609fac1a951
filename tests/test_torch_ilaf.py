"""The port's ILAF against the JAX package on i3d_tiny, and ``cli.fine_tune``.

The same weights (JAX → port through ``from_jax_params``) and the same numpy
clips go through both packages. Tolerances, with the reason for each:
  - the cost trajectory, rtol 1e-3, as the JAX package holds itself to its
    torch oracle (tests/test_i2v_parity.py:355): sign descent keeps only the
    gradient's sign, and the starting modifier sits on clamp boundaries,
    where the JAX package's CPU rebuild halves the gradient of a tie and the
    port passes it whole (ROADMAP Queue 3), which keeps the sign;
  - the cost's gradient w.r.t. the modifier, atol 5e-4·max|g|, at a generic
    modifier: |m| < ε and clean + m inside (0, 1), away from every tie.
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
from i2v_tpu.cli import fine_tune as jfine_tune  # noqa: E402
from i2v_tpu.models import i3d as ji3d  # noqa: E402
from i2v_tpu.models.api import VideoModel as JVideoModel  # noqa: E402
from i2v_tpu.ops import losses as jlosses  # noqa: E402
from i2v_tpu.ops import pallas_kernels as pk  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.cli import attack as attack_cli  # noqa: E402
from i2v_tpu_torch.cli import fine_tune  # noqa: E402
from i2v_tpu_torch.models import VideoModel, i3d, tap_keys_for  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402
from i2v_tpu_torch.ops import kernels, pixel  # noqa: E402

EPS = 16 / 255
STEP_SIZE = 0.01
STEPS = 4
CLIP = (1, 3, 8, 32, 32)
TAPS = tap_keys_for("i3d_resnet50", "ilaf")


@pytest.fixture(scope="module")
def bundles():
    jmod = ji3d.i3d_tiny()
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.zeros(CLIP))
    jb = JVideoModel("i3d_resnet50", jmod, params, TAPS)
    module = from_jax_params(i3d.i3d_tiny(), jax.tree_util.tree_map(np.asarray, params))
    return jb, VideoModel("i3d_resnet50", module.eval().requires_grad_(False), TAPS)


def _pair_clips(seed):
    """A clean clip and an adversarial one at 0.8ε, clipped to [0,1]."""
    rng = np.random.RandomState(seed)
    clean01 = rng.rand(*CLIP).astype(np.float32)
    adv01 = np.clip(clean01 + (0.8 * EPS * np.sign(rng.randn(*CLIP))).astype(np.float32), 0, 1)
    return clean01, adv01


def _norm(x01):
    return np.asarray(jpixel.normalize(jnp.asarray(x01), channel_axis=1))


def _costs(atk, name="v"):
    info = atk.loss_info[name]
    return [float(info[i]["cost"]) for i in range(len(info))]


def test_ilaf_matches_jax(bundles):
    jb, pb = bundles
    clean01, adv01 = _pair_clips(9)
    jatk = jattacks.ILAF(jb, "i3d", step_size=STEP_SIZE, epsilon=EPS, steps=STEPS)
    patk = attacks.ILAF(pb, "i3d", step_size=STEP_SIZE, epsilon=EPS, steps=STEPS)
    jatk(jnp.asarray(_norm(adv01)), jnp.asarray(_norm(clean01)), jnp.asarray([0]),
         video_names=["v"])
    kernels.reset_launches()
    out = patk(_norm(adv01), _norm(clean01), np.asarray([0]), video_names=["v"])
    assert kernels.launches == {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": 0}
    np.testing.assert_allclose(_costs(patk), _costs(jatk), rtol=1e-3)
    assert _costs(patk)[-1] < _costs(patk)[0]
    out01 = pixel.unnormalize(out, channel_axis=1).numpy()
    # no projection of the modifier: the rebuild's clamps keep the clip in
    # the ε-ball and in [0,1]
    assert out01.shape == CLIP and np.isfinite(out01).all()
    assert out01.min() >= -1e-6 and out01.max() <= 1 + 1e-6
    assert np.abs(out01 - clean01).max() <= EPS + 1e-6
    assert np.abs(out01 - adv01).max() > 0


def test_ilaf_gradient_matches_jax_at_a_generic_modifier(bundles):
    jb, pb = bundles
    rng = np.random.RandomState(4)
    clean01 = (0.1 + 0.8 * rng.rand(*CLIP)).astype(np.float32)
    adv01 = (clean01 + 0.5 * EPS * np.sign(rng.randn(*CLIP))).astype(np.float32)
    mod = ((rng.rand(*CLIP) * 2 - 1) * 0.9 * EPS).astype(np.float32)

    jclean, jadv = jnp.asarray(clean01), jnp.asarray(adv01)
    _, ctaps = jb.apply01_taps(jclean)
    _, ataps = jb.apply01_taps(jadv)
    dirs, norms = jlosses.feature_delta_direction(ataps, ctaps)

    def jcost(m):
        _, taps = jb.apply01_taps(pk.rebuild_adv(jclean, m, EPS))
        return jlosses.ilaf_cost(taps, ctaps, dirs, norms)

    want_c, want_g = jax.jit(jax.value_and_grad(jcost))(jnp.asarray(mod))
    atk = attacks.ILAF(pb, "i3d", step_size=STEP_SIZE, epsilon=EPS, steps=STEPS)
    cost_fn = atk.make_cost(torch.from_numpy(adv01), torch.from_numpy(clean01))
    m = torch.from_numpy(mod).requires_grad_(True)
    cost = cost_fn(m)
    (g,) = torch.autograd.grad(cost, m)
    np.testing.assert_allclose(float(cost.detach()), float(want_c), rtol=1e-5)
    scale = float(np.abs(np.asarray(want_g)).max())
    assert scale > 0
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), atol=5e-4 * scale)


class _NanGradAt(torch.autograd.Function):
    """Identity forward; the backward puts a NaN at the first pixel."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g.view(-1)[0] = float("nan")
        return g


class _NanGradModel:
    def __init__(self, bundle):
        self.bundle = bundle
        self.device = bundle.device

    def apply01_taps(self, clip01):
        return self.bundle.apply01_taps(_NanGradAt.apply(clip01))


def test_a_nan_gradient_gives_a_nan_pixel(bundles):
    """``torch.sign(nan)`` is 0 and would leave the pixel where it was; ILAF
    steps with the NaN-keeping sign, as ``jnp.sign`` does."""
    clean01, adv01 = _pair_clips(2)
    atk = attacks.ILAF(_NanGradModel(bundles[1]), "i3d", step_size=STEP_SIZE, epsilon=EPS,
                       steps=1)
    out01 = pixel.unnormalize(atk(_norm(adv01), _norm(clean01), [0]), channel_axis=1).numpy()
    assert np.isnan(out01.reshape(-1)[0])
    assert np.isfinite(out01.reshape(-1)[1:]).all()


def test_ilaf_save_points_to_fine_tune(bundles):
    atk = attacks.ILAF(bundles[1], "i3d")
    with pytest.raises(NotImplementedError, match="cli.fine_tune"):
        atk.save("unused", [])


# -- cli.fine_tune ------------------------------------------------------------

@pytest.fixture
def opt_path(tmp_path, monkeypatch):
    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    return tmp_path


def test_fine_tune_after_attack_writes_the_jax_clis_run_dir(opt_path):
    wb_dir = attack_cli.main(["--attack_method", "BIM", "--step", "2", "--tiny",
                              "--n_synthetic", "2", "--device", "cpu"])
    argv = ["--used_adv", os.path.basename(wb_dir), "--step", "3", "--tiny"]
    assert fine_tune.arg_parse(argv).adv_path == jfine_tune.arg_parse(argv).adv_path
    args = fine_tune.arg_parse(argv + ["--device", "cpu"])
    assert args.used_adv == args.used_ori == wb_dir
    kernels.reset_launches()
    run_dir = fine_tune.run(args)
    assert kernels.launches["rebuild_fwd"] == 0  # the CPU takes the plain version
    assert os.path.basename(run_dir) == "ILAF_i3d_resnet50-ILAF-3-"
    assert sorted(os.listdir(run_dir)) == ["0-adv.npy", "1-adv.npy", "loss_info_1.json"]
    with open(os.path.join(run_dir, "loss_info_1.json")) as f:
        info = json.load(f)
    assert sorted(info) == ["0", "1"] and all(len(v) == 3 for v in info.values())
    assert args.throughput["calls"] == 2
    for label in (0, 1):
        out = np.load(os.path.join(run_dir, f"{label}-adv.npy"))
        ori = np.load(os.path.join(wb_dir, f"{label}-ori.npy"))
        d = pixel.unnormalize(torch.from_numpy(out), 0) - pixel.unnormalize(
            torch.from_numpy(ori), 0)
        assert out.shape == (3, 8, 32, 32) and float(d.abs().max()) <= EPS + 1e-5


def test_fine_tune_without_oris_stops_before_building_a_model(opt_path, monkeypatch):
    run_dir = opt_path / "Image-run"
    run_dir.mkdir()
    np.save(run_dir / "0-adv.npy", np.zeros((3, 8, 32, 32), np.float32))

    def no_model(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(fine_tune, "get_video_model", no_model)
    with pytest.raises(SystemExit, match="no ori artifact"):
        fine_tune.main(["--used_adv", "Image-run", "--tiny", "--device", "cpu"])
    with pytest.raises(SystemExit, match=r"no \{id\}-adv.npy"):
        fine_tune.main(["--used_adv", str(opt_path), "--tiny", "--device", "cpu"])


def test_fine_tune_on_cuda_without_a_card_stops(opt_path, monkeypatch):
    wb_dir = attack_cli.main(["--attack_method", "FGSM", "--tiny", "--n_synthetic", "1",
                              "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        fine_tune.main(["--used_adv", wb_dir, "--tiny", "--step", "1"])
