"""The port's TemporalTranslation against the JAX package's, on i3d_tiny.

The same weights (JAX → port through ``from_jax_params``) and the same numpy
clips go through both attacks, at kernlen 3 (kernlen 5 for the random
moves). Tolerances as in test_torch_whitebox.py: the step-0 cost rtol 1e-5
and the step-0 (mixed) gradient atol 1e-5·max|g|; cost trajectories rtol
1e-5, output pixels differing at most 0.1%. 'random' moves draw from
``jax.random`` in one package and a ``torch.Generator`` in the other, so
they are compared at pinned shifts, and the port's draws are tested on
their own. The gradient itself is held against a variant-by-variant oracle
at 1e-5·max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

import i2v_tpu.attacks as jattacks  # noqa: E402
from i2v_tpu.attacks import temporal as jtemporal  # noqa: E402
from i2v_tpu.models import i3d as ji3d  # noqa: E402
from i2v_tpu.models.api import VideoModel as JVideoModel  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu.ops import smoothing as jsmoothing  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.models import VideoModel, i3d  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402
from i2v_tpu_torch.ops import kernels, losses, pixel, smoothing  # noqa: E402

EPS = 16 / 255
CLIP = (2, 3, 8, 32, 32)
LABELS = np.asarray([2, 5])
COST_RTOL = 1e-5
GRAD_ATOL = 1e-5
PIXEL_SHARE = 1e-3


@pytest.fixture(scope="module")
def bundles():
    jmod = ji3d.i3d_tiny()
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.zeros((1,) + CLIP[1:]))
    jb = JVideoModel("i3d_resnet50", jmod, params, ())
    module = from_jax_params(i3d.i3d_tiny(), jax.tree_util.tree_map(np.asarray, params))
    return jb, VideoModel("i3d_resnet50", module.eval().requires_grad_(False), ())


@pytest.fixture(scope="module")
def videos():
    clips01 = np.random.RandomState(42).rand(*CLIP).astype(np.float32)
    return np.array(jpixel.normalize(jnp.asarray(clips01), channel_axis=1))


def _random_bundle():
    return VideoModel("i3d_resnet50", i3d.i3d_tiny().eval().requires_grad_(False), ())


def _costs(atk, name="v"):
    return np.asarray([float(atk.loss_info[name][i]["cost"])
                       for i in range(len(atk.loss_info[name]))])


def _compare(jatk, patk, videos):
    jadv = np.asarray(jatk(jnp.asarray(videos), jnp.asarray(LABELS), video_names=["v"]))
    kernels.reset_launches()
    padv = patk(videos, LABELS, ["v"]).numpy()
    assert kernels.launches["sign_step"] == 0  # the CPU takes the plain version
    adv01 = pixel.unnormalize(torch.from_numpy(padv), channel_axis=1)
    clean01 = pixel.unnormalize(torch.from_numpy(videos), channel_axis=1)
    assert float(adv01.min()) >= -1e-5 and float(adv01.max()) <= 1 + 1e-5
    assert float((adv01 - clean01).abs().max()) <= EPS + 1e-5
    jc, pc = _costs(jatk), _costs(patk)
    assert len(pc) == patk.steps
    np.testing.assert_allclose(pc, jc, rtol=COST_RTOL)
    assert len(pc) == 1 or pc[-1] > pc[0]
    assert np.mean(padv != jadv) <= PIXEL_SHARE


def _assert_step0_matches_jax(jatk, patk, videos, monkeypatch):
    """The step-0 cost and mixed gradient: the JAX runner's gradient
    function, taken from its call of ``run_sign_attack``, against the port's."""
    clean01 = np.array(jpixel.unnormalize(jnp.asarray(videos), channel_axis=1))
    monkeypatch.setattr(jtemporal, "run_sign_attack",
                        lambda grad_fn, c, l, cfg, rng: grad_fn(c, l, rng))
    jcost, jg = jatk._build_runner(clean01.shape)(jatk.model.params, jnp.asarray(clean01),
                                                  jnp.asarray(LABELS), jax.random.PRNGKey(0))
    pcost, pg = patk._build_grad_fn()(torch.from_numpy(clean01), torch.from_numpy(LABELS),
                                      torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(pcost), float(jcost), rtol=COST_RTOL)
    scale = float(np.abs(np.asarray(jg)).max())
    assert scale > 0
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0, atol=GRAD_ATOL * scale)


@pytest.mark.parametrize("move_type", ["adj", "large"])
@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("weight,chunk", [(0.0, 3), (0.5, 1)])
def test_tt_matches_jax(bundles, videos, monkeypatch, move_type, momentum, weight, chunk):
    """'large' maps the moves ±1 to ±4 at T = 8, one and the same variant,
    so its same-position sum adds the gradients of frames four apart; at this
    size that trajectory is chaotic (2e-5 of the pixels differ after one
    step, 0.4% after two), so 'large' is held at step 0 and over one step."""
    jb, pb = bundles
    params = dict(kernlen=3, momentum=momentum, weight=weight, move_type=move_type,
                  kernel_mode="gaussian", chunk=chunk)
    steps = 3 if move_type == "adj" else 1
    _compare(jattacks.TemporalTranslation(jb, params, steps=steps),
             attacks.TemporalTranslation(pb, params, steps=steps), videos)
    _assert_step0_matches_jax(jattacks.TemporalTranslation(jb, params),
                              attacks.TemporalTranslation(pb, params), videos, monkeypatch)


def test_tt_random_moves_match_jax_at_pinned_shifts(bundles, videos, monkeypatch):
    """Applied shifts that differ from the nominal moves: the gradients are
    rolled back by the nominal moves, in both packages."""
    jb, pb = bundles
    params = dict(kernlen=5, momentum=True, weight=0.5, move_type="random",
                  kernel_mode="linear", chunk=5)
    pinned = [-5, -3, 0, 6, 1]
    jatk = jattacks.TemporalTranslation(jb, params, steps=2)
    jatk._static_shifts = lambda frames: jnp.asarray(pinned, dtype=jnp.int32)
    patk = attacks.TemporalTranslation(pb, params, steps=2)
    patk._shifts = lambda frames, generator: list(pinned)
    _compare(jatk, patk, videos)
    _assert_step0_matches_jax(jatk, patk, videos, monkeypatch)


def test_random_shift_draws():
    """Each shift is randint(0, 101) % T with its move's sign; move 0 stays
    0; every residue is drawn."""
    atk = attacks.TemporalTranslation(_random_bundle(), dict(kernlen=7, move_type="random"))
    gen = torch.Generator().manual_seed(0)
    draws = np.asarray([atk._shifts(8, gen) for _ in range(400)])
    moves = np.asarray(atk.moves)
    assert draws.shape == (400, 7) and (draws[:, moves == 0] == 0).all()
    for j in np.flatnonzero(moves):
        col = draws[:, j]
        assert (np.sign(col[col != 0]) == np.sign(moves[j])).all()
        assert set(np.abs(col)) == set(range(8))
    assert atk._shifts(8, gen) != atk._shifts(8, gen)


def test_tt_gradient_is_the_variants_own_mean_ce_gradients(bundles, videos):
    """A chunk of variants in one batch gives each variant the gradient of
    its own mean CE: the mixed gradient equals a one-variant-at-a-time
    oracle, whatever the chunk."""
    _, pb = bundles
    clean01 = pixel.unnormalize(torch.from_numpy(videos), channel_axis=1)
    labels = torch.from_numpy(LABELS)
    weight = 0.3
    kernel = smoothing.temporal_kernel(5, "gaussian")
    x = pixel.normalize(clean01, channel_axis=1)
    s_grad = d_grad = 0
    costs = []
    for k, move in zip(kernel, range(-2, 3)):
        v = torch.roll(x, move, dims=2).requires_grad_(True)
        cost = losses.cross_entropy(pb.apply_norm(v), labels)
        (g,) = torch.autograd.grad(cost, v)
        costs.append(float(cost.detach()))
        s_grad = s_grad + float(k) * g
        d_grad = d_grad + float(k) * torch.roll(g, -move, dims=2)
    want = (1 - weight) * s_grad + weight * d_grad
    for chunk in (5, 1):
        atk = attacks.TemporalTranslation(pb, dict(kernlen=5, weight=weight, chunk=chunk))
        cost, got = atk._build_grad_fn()(clean01, labels, None)
        np.testing.assert_allclose(float(cost), np.mean(costs), rtol=1e-6)
        torch.testing.assert_close(got, want, rtol=0, atol=GRAD_ATOL * float(want.abs().max()))


@pytest.mark.parametrize("kernlen,chunk,want", [(15, 5, 5), (15, 4, 3), (15, 20, 15), (3, 2, 1),
                                                (5, 0, 1)])
def test_chunk_snaps_to_a_divisor_of_the_variant_count(kernlen, chunk, want):
    atk = attacks.TemporalTranslation(_random_bundle(), dict(kernlen=kernlen, chunk=chunk))
    assert atk._chunk_size() == want and len(atk.moves) == kernlen


def test_moves_and_variants_match_jax():
    clip = np.random.RandomState(0).randn(2, 3, 8, 4, 4).astype(np.float32)
    shifts = [-9, -1, 0, 3, 17]
    np.testing.assert_array_equal(
        smoothing.cycle_variants(torch.from_numpy(clip), shifts).numpy(),
        np.asarray(jsmoothing.cycle_variants(jnp.asarray(clip), shifts)))
    pairs = [(0, 7), (2, 3)]
    np.testing.assert_array_equal(
        smoothing.exchange_frames(torch.from_numpy(clip), pairs).numpy(),
        np.asarray(jsmoothing.exchange_frames(jnp.asarray(clip), pairs)))
    for frames in (8, 32):
        for move in range(-7, 8):
            assert smoothing.large_move_shift(move, frames) == \
                jsmoothing.large_move_shift(move, frames)
    stack = np.random.RandomState(1).randn(5, 2, 3, 8, 4, 4).astype(np.float32)
    k = jsmoothing.temporal_kernel(5, "linear")
    np.testing.assert_allclose(
        smoothing.smooth_variant_grads(torch.from_numpy(stack), k).numpy(),
        np.asarray(jsmoothing.smooth_variant_grads(jnp.asarray(stack), k)), rtol=1e-6, atol=1e-6)


def test_tt_records_one_cost_a_step_and_redraws_each_call(bundles, videos):
    _, pb = bundles
    atk = attacks.TemporalTranslation(pb, dict(kernlen=3, move_type="random", chunk=3), steps=2)
    a = atk(videos, LABELS, ["a"]).numpy()
    b = atk(videos, LABELS, ["b"]).numpy()
    assert sorted(atk.loss_info) == ["a", "b"] and len(atk.loss_info["a"]) == 2
    assert atk._calls == 2 and not np.array_equal(a, b)
