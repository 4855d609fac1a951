"""The port's DI/TI/TAP white-box attacks, their ops and ``--remat`` against
the JAX package's, on i3d_tiny.

The same weights (JAX → port through ``from_jax_params``) and the same numpy
clips go through both packages. Tolerances, as in test_torch_whitebox.py:
step-0 cost rtol 1e-5 and gradient atol 1e-5·max|g| (summation order, ~1e-7
relative a sum), cost trajectories rtol 1e-5, output pixels differing at
most 0.1% (a sign flips where |g| is within that error of 0). Smoothing
outputs rtol 1e-5: banded matmuls there, shifted-slice sums here.

DI's draws come from ``jax.random`` in one package and a ``torch.Generator``
in the other, so the attacks are compared at pinned draws (both packages'
``input_diversity`` replaced by the same :func:`diversity_gather`), and the
port's draws are tested on their own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import torch_rng_restored  # noqa: E402,F401

import i2v_tpu.attacks as jattacks  # noqa: E402
from i2v_tpu.models import i3d as ji3d  # noqa: E402
from i2v_tpu.models.api import VideoModel as JVideoModel  # noqa: E402
from i2v_tpu.ops import activations as jactivations  # noqa: E402
from i2v_tpu.ops import diversity as jdiversity  # noqa: E402
from i2v_tpu.ops import losses as jlosses  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu.ops import smoothing as jsmoothing  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.attacks.core import _chunked  # noqa: E402
from i2v_tpu_torch.models import VideoModel, get_video_model, i3d  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402
from i2v_tpu_torch.ops import activations, diversity, kernels, losses, pixel, smoothing  # noqa: E402

EPS = 16 / 255
CLIP = (2, 3, 8, 32, 32)
LABELS = np.asarray([1, 3])
TAPS = ("res_layer1", "res_layer2")
COST_RTOL = 1e-5
GRAD_ATOL = 1e-5
SMOOTH_RTOL = 1e-5
PIXEL_SHARE = 1e-3
LOW, HIGH = diversity.default_range(32)   # DI's resize range at 32²: [32, 36)
PINNED = (LOW + 2, 1, 2)                  # (rnd, pad_top, pad_left) of the attack tests

# name → the attack, built from a package's attacks module (JAX or port) on a bundle
ATTACKS = {
    "DIFGSM": lambda mod, m: mod.DIFGSM(m, steps=4),
    "DIFGSM-momentum": lambda mod, m: mod.DIFGSM(m, steps=3, momentum=True),
    "TIFGSM": lambda mod, m: mod.TIFGSM(m, steps=4, kernlen=7),
    "TIFGSM3D": lambda mod, m: mod.TIFGSM3D(m, steps=4, kernlen=5),
    "TIFGSM3D-momentum": lambda mod, m: mod.TIFGSM3D(m, steps=3, kernlen=3, momentum=True),
}


@pytest.fixture(scope="module")
def bundles():
    jmod = ji3d.i3d_tiny()
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.zeros((1,) + CLIP[1:]))
    jb = JVideoModel("i3d_resnet50", jmod, params, TAPS)
    module = from_jax_params(i3d.i3d_tiny(), jax.tree_util.tree_map(np.asarray, params))
    return jb, VideoModel("i3d_resnet50", module.eval().requires_grad_(False), TAPS)


@pytest.fixture(scope="module")
def videos():
    clips01 = np.random.RandomState(0).rand(*CLIP).astype(np.float32)
    return np.array(jpixel.normalize(jnp.asarray(clips01), channel_axis=1))


@pytest.fixture
def pinned_di(monkeypatch):
    """Both packages' DI transform replaced by the same pinned draws."""
    rnd, top, left = PINNED
    monkeypatch.setattr(jdiversity, "input_diversity", lambda x, rng, **k:
                        jdiversity.diversity_gather(x, rnd, top, left, LOW, HIGH))
    monkeypatch.setattr(diversity, "input_diversity", lambda x, gen, **k:
                        diversity.diversity_gather(x, rnd, top, left, LOW, HIGH))


def _costs(atk, key="cost", name="v"):
    return np.asarray([float(atk.loss_info[name][i][key])
                       for i in range(len(atk.loss_info[name]))])


def _clean01(videos):
    return np.array(jpixel.unnormalize(jnp.asarray(videos), channel_axis=1))


def _check_invariants(adv_norm, videos_norm):
    adv01 = pixel.unnormalize(torch.as_tensor(adv_norm), channel_axis=1).numpy()
    clean01 = pixel.unnormalize(torch.as_tensor(videos_norm), channel_axis=1).numpy()
    assert adv01.min() >= -1e-5 and adv01.max() <= 1 + 1e-5
    assert np.abs(adv01 - clean01).max() <= EPS + 1e-5


def _assert_grad_close(got, want):
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_ATOL * scale)


# -- DI ----------------------------------------------------------------------

@pytest.mark.parametrize("rnd", [LOW, LOW + 1, HIGH - 1])
def test_diversity_gather_is_bit_identical_to_jax(rnd):
    """Every pad the draw allows, 0 and high − rnd − 1 included."""
    x = np.random.RandomState(rnd).randn(2, 3, 2, LOW, LOW).astype(np.float32)
    for top in range(HIGH - rnd):
        for left in (0, HIGH - rnd - 1):
            want = np.asarray(jdiversity.diversity_gather(jnp.asarray(x), rnd, top, left,
                                                          LOW, HIGH))
            got = diversity.diversity_gather(torch.from_numpy(x), rnd, top, left, LOW, HIGH)
            np.testing.assert_array_equal(got.numpy(), want)


def test_diversity_gather_is_the_resize_pad_resize_chain():
    """The reference's chain with explicit nearest resizes and a pad."""
    x = torch.randn(3, LOW, LOW, generator=torch.Generator().manual_seed(0))
    rnd, top, left = LOW + 2, 1, 2
    up = torch.nn.functional.interpolate(x[None], size=(rnd, rnd), mode="nearest")[0]
    canvas = torch.zeros(3, HIGH, HIGH)
    canvas[:, top:top + rnd, left:left + rnd] = up
    want = torch.nn.functional.interpolate(canvas[None], size=(LOW, LOW), mode="nearest")[0]
    torch.testing.assert_close(diversity.diversity_gather(x, rnd, top, left, LOW, HIGH), want,
                               rtol=0, atol=0)


def test_input_diversity_draws():
    """keep_prob = 1 is the identity; the draws lie in their ranges, and the
    transform applies about half the time at keep_prob 0.5."""
    x = torch.randn(1, 3, 2, LOW, LOW)
    gen = torch.Generator().manual_seed(0)
    assert diversity.input_diversity(x, gen, keep_prob=1.0) is x
    gen = torch.Generator().manual_seed(1)
    draws = [diversity.draw(gen, LOW, HIGH) for _ in range(4000)]
    applied = np.mean([d[0] for d in draws])
    assert 0.46 < applied < 0.54
    assert {d[1] for d in draws} == set(range(LOW, HIGH))
    for _, rnd, top, left in draws:
        assert 0 <= top < HIGH - rnd and 0 <= left < HIGH - rnd
    # every pad value is drawn for the smallest resize
    assert {d[2] for d in draws if d[1] == LOW} == set(range(HIGH - LOW))


def test_difgsm_step0_cost_and_gradient_match_jax_at_pinned_draws(bundles, videos, pinned_di):
    jb, pb = bundles
    jatk, patk = jattacks.DIFGSM(jb), attacks.DIFGSM(pb)
    clean01 = _clean01(videos)
    jcost, jg = jax.jit(jatk._build_grad_fn(jatk.model))(
        jnp.asarray(clean01), jnp.asarray(LABELS), jax.random.PRNGKey(0))
    pcost, pg = patk._build_grad_fn(patk.model)(torch.from_numpy(clean01),
                                                torch.from_numpy(LABELS), None)
    np.testing.assert_allclose(float(pcost), float(jcost), rtol=COST_RTOL)
    _assert_grad_close(pg.numpy(), np.asarray(jg))
    # the pinned transform is not the identity: the gradient differs from BIM's
    _, bg = attacks.BIM(pb)._build_grad_fn(pb)(torch.from_numpy(clean01),
                                                 torch.from_numpy(LABELS), None)
    assert not np.allclose(pg.numpy(), bg.numpy(), atol=GRAD_ATOL * float(pg.abs().max()))


@pytest.mark.parametrize("batch,chunk", [(2, 1), (3, 2)])
def test_chunked_difgsm_equals_the_full_batch_at_the_same_seed(bundles, videos, batch, chunk):
    """Every chunk sees the step's one draw, as in the JAX engine: a chunked
    DIFGSM is the full-batch DIFGSM (at 3 clips, chunk 2 snaps to 1)."""
    _, pb = bundles
    v = np.concatenate([videos, videos[:1]])[:batch]
    labels = np.concatenate([LABELS, LABELS[:1]])[:batch]
    full = attacks.DIFGSM(pb, steps=6)
    chunked = attacks.DIFGSM(pb, steps=6)
    chunked.cfg = dataclasses.replace(chunked.cfg, batch_chunk=chunk)
    np.testing.assert_allclose(chunked(v, labels).numpy(), full(v, labels).numpy(), atol=2e-6)


def test_chunked_grad_fn_restarts_every_chunk_at_the_steps_draw(bundles, videos):
    """Every chunk of a step gets the step's one row of the call's draws
    (the loop reads the row once a step and hands it to each chunk)."""
    _, pb = bundles
    seen = []

    def grad_fn(adv, labels, draws):
        seen.append(draws)
        return torch.zeros(()), torch.zeros_like(adv)

    rows = torch.from_numpy(diversity.draw_table(torch.Generator().manual_seed(3), 2, LOW, HIGH))
    row0, row1 = rows[0], rows[1]
    clean01 = pixel.unnormalize(torch.from_numpy(videos), channel_axis=1)
    _chunked(grad_fn, 2, 1)(clean01, torch.from_numpy(LABELS), row0)
    _chunked(grad_fn, 2, 1)(clean01, torch.from_numpy(LABELS), row1)
    assert seen[0] is row0 and seen[1] is row0 and seen[2] is row1 and seen[3] is row1
    assert not torch.equal(row0, row1)


# -- TI and TAP smoothing -----------------------------------------------------

def _grad_like(seed=0, shape=(2, 3, 6, 20, 24)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("kernlen", [3, 7, 15])
def test_ti_smoothing_matches_jax(kernlen):
    g = _grad_like(kernlen)
    k1d = jsmoothing.gaussian_1d(kernlen)
    np.testing.assert_array_equal(smoothing.gaussian_1d(kernlen), k1d)
    pairs = [
        (smoothing.ti_smooth_2d_separable, jsmoothing.ti_smooth_2d_separable, k1d),
        (smoothing.depthwise_conv3d_separable, jsmoothing.depthwise_conv3d_separable, k1d),
        (smoothing.ti_smooth_2d, jsmoothing.ti_smooth_2d, jsmoothing.ti_kernel_2d(kernlen)),
        (smoothing.depthwise_conv3d, jsmoothing.depthwise_conv3d,
         jsmoothing.ti_kernel_3d(kernlen)),
    ]
    for port_fn, jax_fn, kernel in pairs:
        want = np.asarray(jax_fn(jnp.asarray(g), kernel))
        got = port_fn(torch.from_numpy(g), kernel).numpy()
        np.testing.assert_allclose(got, want, rtol=SMOOTH_RTOL,
                                   atol=SMOOTH_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("conv3d", [True, False])
def test_tap_depthwise_smoothing_and_its_gradient_match_jax(conv3d):
    x = _grad_like(1)
    gout = _grad_like(2)
    if conv3d:
        kernel = jsmoothing.uniform_kernel_3d(3, 3)
        jfn, pfn = jsmoothing.depthwise_conv3d, smoothing.depthwise_conv3d
    else:
        kernel = jsmoothing.uniform_kernel_2d(3)
        jfn, pfn = jsmoothing.depthwise_conv2d_frames, smoothing.depthwise_conv2d_frames
    want, vjp = jax.vjp(lambda t: jfn(t, kernel), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(gout))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pfn(xt, kernel)
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(gout))
    for a, b in ((got.detach().numpy(), np.asarray(want)), (got_g.numpy(), np.asarray(want_g))):
        np.testing.assert_allclose(a, b, rtol=SMOOTH_RTOL, atol=SMOOTH_RTOL * float(np.abs(b).max()))


def test_asymmetric_kernel_correlates_and_its_backward_is_the_adjoint():
    """A kernel without symmetry pins the correlation's orientation and the
    backward's flip, against torch's own conv (which correlates)."""
    x = torch.from_numpy(_grad_like(3, (1, 3, 5, 9, 11))).double().requires_grad_(True)
    kernel = np.random.RandomState(4).rand(3, 5, 3).astype(np.float32)
    got = smoothing.depthwise_conv3d(x, kernel)
    filt = torch.from_numpy(np.stack([kernel] * 3)[:, None]).double()
    want = torch.nn.functional.conv3d(x, filt, padding=(1, 2, 1), groups=3)
    torch.testing.assert_close(got, want)
    torch.autograd.gradcheck(lambda t: smoothing.depthwise_conv3d(t, kernel), (x[:, :, :3, :6, :5],))


def test_kernel_builders_match_jax():
    for k in (1, 3, 15):
        np.testing.assert_array_equal(smoothing.ti_kernel_2d(k), jsmoothing.ti_kernel_2d(k))
        np.testing.assert_array_equal(smoothing.ti_kernel_3d(k), jsmoothing.ti_kernel_3d(k))
        np.testing.assert_array_equal(smoothing.uniform_kernel_2d(k),
                                      jsmoothing.uniform_kernel_2d(k))
        np.testing.assert_array_equal(smoothing.uniform_kernel_3d(k, 3),
                                      jsmoothing.uniform_kernel_3d(k, 3))
        for mode in ("gaussian", "linear", "uniform", "random"):
            np.testing.assert_array_equal(smoothing.temporal_kernel(k, mode),
                                          jsmoothing.temporal_kernel(k, mode))
    np.testing.assert_array_equal(smoothing.temporal_kernel(1, "gaussian"), [1.0])
    with pytest.raises(ValueError):
        smoothing.temporal_kernel(3, "bogus")


# -- TAP's losses --------------------------------------------------------------

def test_signed_sqrt_gradient_is_zero_at_zero_and_finite():
    x = np.asarray([-4.0, -1e-6, 0.0, -0.0, 1e-6, 2.25], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = activations.signed_sqrt(xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    jy, jg = jax.value_and_grad(lambda t: jnp.sum(jactivations.signed_sqrt(t)))(jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jactivations.signed_sqrt(x)),
                               rtol=1e-6)
    assert np.isfinite(g.numpy()).all() and g[2] == 0 and g[3] == 0
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    # the plain composition's gradient is NaN there
    xp = torch.zeros(1, requires_grad=True)
    (gp,) = torch.autograd.grad((torch.sign(xp) * torch.sqrt(torch.abs(xp))).sum(), xp)
    assert torch.isnan(gp).all()


@pytest.mark.parametrize("same", [False, True])
def test_tap_feature_distance_matches_jax(same):
    rng = np.random.RandomState(5)
    # ReLU-like taps: exact zeros on about half the units
    clean = [np.maximum(rng.randn(*s), 0).astype(np.float32) for s in ((2, 4, 3, 5, 5),
                                                                       (2, 8, 3, 3, 3))]
    adv = clean if same else [np.maximum(c + 0.3 * rng.randn(*c.shape), 0).astype(np.float32)
                              for c in clean]

    def jfn(a):
        return jnp.sum(jlosses.tap_feature_distance(a, [jnp.asarray(c) for c in clean], 2))

    jd = np.asarray(jlosses.tap_feature_distance([jnp.asarray(a) for a in adv],
                                                 [jnp.asarray(c) for c in clean], 2))
    jg = jax.grad(jfn)([jnp.asarray(a) for a in adv])
    at = [torch.from_numpy(a).requires_grad_(True) for a in adv]
    d = losses.tap_feature_distance(at, [torch.from_numpy(c) for c in clean], 2)
    g = torch.autograd.grad(d.sum(), at)
    assert d.shape == (2,)
    np.testing.assert_allclose(d.detach().numpy(), jd, rtol=1e-5)
    for a, b in zip(g, jg):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    if same:
        assert all(float(a.abs().max()) == 0 for a in g)


# -- the attacks against JAX ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(ATTACKS))
def test_attack_matches_jax(bundles, videos, pinned_di, name):
    jb, pb = bundles
    jatk, patk = ATTACKS[name](jattacks, jb), ATTACKS[name](attacks, pb)
    jadv = np.asarray(jatk(jnp.asarray(videos), jnp.asarray(LABELS), video_names=["v"]))
    kernels.reset_launches()
    padv = patk(videos, LABELS, ["v"]).numpy()
    assert kernels.launches["sign_step"] == 0  # the CPU takes the plain version
    _check_invariants(padv, videos)
    jc, pc = _costs(jatk), _costs(patk)
    assert len(pc) == patk.steps == jatk.steps
    np.testing.assert_allclose(pc, jc, rtol=COST_RTOL)
    assert pc[-1] > pc[0]  # the CE cost is ascended
    assert np.mean(padv != jadv) <= PIXEL_SHARE
    np.testing.assert_allclose(padv, jadv, rtol=0, atol=2 * EPS / min(pixel.IMAGENET_STD))


TAP_PARAMS = dict(kernlen=3, temporal_kernlen=3, conv3d=True)
TAP_KEYS = ("cost", "ce loss", "reg_cost", "distance")


def _jax_tap_cost(jb, clean01, labels):
    """The JAX TAP objective as its runner builds it (whitebox.py:310-329)."""
    x_clean = jpixel.normalize(jnp.asarray(clean01), channel_axis=1)
    _, clean_taps = jb.apply_norm_taps(x_clean)
    kernel = jsmoothing.uniform_kernel_3d(3, 3)

    def cost_fn(x_norm):
        logits, taps = jb.apply_norm_taps(x_norm)
        ce = jlosses.cross_entropy(logits, jnp.asarray(labels))
        dist = jnp.sum(jlosses.tap_feature_distance(taps, clean_taps, clean01.shape[0]))
        perts = jpixel.scale_perts(x_norm - x_clean, channel_axis=1)
        reg = jnp.sum(jnp.abs(jsmoothing.depthwise_conv3d(perts, kernel)))
        return ce + 1e3 * reg + 0.05 * dist, (ce, reg, dist)

    return jax.jit(jax.value_and_grad(cost_fn, has_aux=True))


def test_tap_cost_components_and_gradient_match_jax_at_a_generic_point(bundles, videos):
    jb, pb = bundles
    clean01 = _clean01(videos)
    rng = np.random.RandomState(6)
    adv01 = np.clip(clean01 + 0.8 * EPS * np.tanh(rng.randn(*clean01.shape)), 0, 1)
    adv01 = adv01.astype(np.float32)
    (jcost, jaux), jg = _jax_tap_cost(jb, clean01, LABELS)(
        jpixel.normalize(jnp.asarray(adv01), channel_axis=1))
    patk = attacks.TAP(pb, TAP_PARAMS)
    pcosts, pg = patk._build_grad_fn(torch.from_numpy(clean01))(
        torch.from_numpy(adv01), torch.from_numpy(LABELS), None)
    np.testing.assert_allclose(pcosts.numpy(), [float(jcost)] + [float(a) for a in jaux],
                               rtol=COST_RTOL)
    assert all(float(c) > 0 for c in pcosts[1:])
    _assert_grad_close(pg.numpy(), np.asarray(jg))


def test_tap_attack_matches_jax(bundles, videos):
    """The four cost components along the trajectory.

    The JAX package's own TAP trajectory cannot be the reference: inside its
    jitted scan, XLA fuses ``normalize(adv)`` and ``normalize(clean)``
    differently, so at step 0 its perturbation is last-bit rounding rather
    than 0 (``reg_cost`` ≈ 1e-3 where it is exactly 0 here), and η = 1e3
    makes the sign of that noise its first step. So the port's components at
    each of its own steps are held against the JAX objective at the same
    point, and the JAX attack's step-0 CE and distance against the port's."""
    jb, pb = bundles
    steps = 4
    patk = attacks.TAP(pb, TAP_PARAMS, steps=steps)
    seen, build = [], patk._build_grad_fn

    def recording(clean01, *model_and_weight):
        grad_fn = build(clean01, *model_and_weight)

        def wrapped(adv01, labels, generator):
            seen.append(adv01.numpy().copy())
            return grad_fn(adv01, labels, generator)

        return wrapped

    patk._build_grad_fn = recording
    padv = patk(videos, LABELS, ["v"]).numpy()
    _check_invariants(padv, videos)
    assert list(patk.loss_info) == ["v"] and len(patk.loss_info["v"]) == steps == len(seen)
    jcost = _jax_tap_cost(jb, _clean01(videos), LABELS)
    for i, adv01 in enumerate(seen):
        (total, aux), _ = jcost(jpixel.normalize(jnp.asarray(adv01), channel_axis=1))
        want = [float(total)] + [float(a) for a in aux]
        got = [float(patk.loss_info["v"][i][k]) for k in TAP_KEYS]
        # at step 0 the smoothness term is exactly 0 in both, and the
        # distance is the 1e-6 of each sqrt's ε
        np.testing.assert_allclose(got, want, rtol=COST_RTOL, atol=1e-6 if i == 0 else 0)
    assert float(patk.loss_info["v"][0]["reg_cost"]) == 0.0
    costs = _costs(patk)
    assert costs[-1] > costs[0]
    jatk = jattacks.TAP(jb, TAP_PARAMS, steps=steps)
    jatk(jnp.asarray(videos), jnp.asarray(LABELS), video_names=["v"])
    for key in ("ce loss", "distance"):
        np.testing.assert_allclose(_costs(patk, key)[0], _costs(jatk, key)[0], rtol=COST_RTOL)


def test_tap_ignores_the_generator_and_counts_calls(bundles, videos):
    _, pb = bundles
    atk = attacks.TAP(pb, TAP_PARAMS, steps=1)
    a = atk(videos, LABELS).numpy()
    b = atk(videos, LABELS).numpy()
    np.testing.assert_array_equal(a, b)
    assert atk._calls == 2


# -- --remat ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["i3d_resnet50", "slowfast_resnet50", "tpn_resnet50"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_remat_keeps_logits_and_input_gradients(name, scale):
    clip = torch.from_numpy(np.random.RandomState(7).rand(2, 3, 8, 32, 32).astype(np.float32))
    labels = torch.tensor([1, 4])
    out = {}
    for remat in (False, True):
        bundle = get_video_model(name, device="cpu", tiny=True, remat=remat)
        bundle = bundle.with_relu_grad_scale(scale)
        assert bundle.module.remat is remat
        x = pixel.normalize(clip, channel_axis=1).requires_grad_(True)
        logits = bundle.apply_norm(x)
        (g,) = torch.autograd.grad(losses.cross_entropy(logits, labels), x)
        with torch.no_grad():
            plain = bundle.apply_norm(x)
        out[remat] = (logits.detach(), g, plain)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][2], out[False][2])
    atol = 1e-6 * float(out[False][1].abs().max())
    torch.testing.assert_close(out[True][1], out[False][1], rtol=0, atol=atol)
