"""The port's pixel, loss and gradient-normalization functions against the
JAX package's, on the same numpy inputs. Elementwise pixel math must agree
exactly (after the layout transpose: NCHW frames in the port, NHWC in the
JAX package); reductions agree to rtol 1e-6, since the two sum in different
orders."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.ops import grads as jgrads  # noqa: E402
from i2v_tpu.ops import losses as jlosses  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu_torch.ops import grads, losses, pixel  # noqa: E402

EPS = float(np.float32(16 / 255))


def _clip(seed, shape=(2, 3, 4, 8, 8)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("fn", ["normalize", "unnormalize"])
def test_normalize_unnormalize_match_jax(fn):
    x = _clip(0) * 4 - 2
    want = np.asarray(getattr(jpixel, fn)(jnp.asarray(x), channel_axis=1))
    got = getattr(pixel, fn)(torch.from_numpy(x), channel_axis=1).numpy()
    np.testing.assert_array_equal(got, want)


def test_normalize_statistics_are_made_once_and_serve_every_mode():
    """The mean and std are made once a (dtype, device, layout), so that no
    forward builds a tensor from Python numbers on a card (a blocking copy);
    made first under inference mode, they still let a graph save them."""
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 3, 4, 5, 5).astype(np.float32))
    with torch.inference_mode():
        want = pixel.normalize(x, channel_axis=1)
    assert pixel._stats(x, 1)[0] is pixel._stats(x.clone(), 1)[0]
    leaf = x.clone().requires_grad_(True)
    got = pixel.normalize(leaf, channel_axis=1)
    got.sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    np.testing.assert_allclose(leaf.grad[0, :, 0, 0, 0].numpy(),
                               1 / np.float32(pixel.IMAGENET_STD), rtol=1e-6)


def test_flatten_and_unflatten_match_jax():
    x = _clip(1)
    want = np.asarray(jpixel.flatten_clip_to_frames(jnp.asarray(x)))  # NHWC
    frames = pixel.flatten_clip_to_frames(torch.from_numpy(x))           # NCHW
    np.testing.assert_array_equal(frames.numpy().transpose(0, 2, 3, 1), want)
    np.testing.assert_array_equal(pixel.unflatten_frames_to_clip(frames, 2).numpy(), x)


def test_projection_and_sign_step_match_jax():
    clean, adv, g = _clip(2), _clip(3), _clip(4) - 0.5
    g[0, 0, 0, 0, :3] = 0.0  # sign(0) = 0
    want = np.asarray(jpixel.project_linf(jnp.asarray(adv), jnp.asarray(clean), EPS))
    got = pixel.project_linf(torch.from_numpy(adv), torch.from_numpy(clean), EPS)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jpixel.sign_step_project(jnp.asarray(adv), jnp.asarray(g),
                                               jnp.asarray(clean), EPS / 10, EPS))
    got = pixel.sign_step_project(torch.from_numpy(adv), torch.from_numpy(g),
                                  torch.from_numpy(clean), EPS / 10, EPS)
    np.testing.assert_array_equal(got.numpy(), want)


def _pair(seed, zero_rows=False):
    """(adv taps, clean taps), correlated as an attack's are: cosines stay
    well away from 0, where a relative tolerance would mean nothing."""
    rng = np.random.RandomState(seed)
    clean = [rng.randn(6, 4, 5, 5).astype(np.float32), rng.randn(6, 7, 3, 3).astype(np.float32)]
    adv = [(c + 0.5 * rng.randn(*c.shape)).astype(np.float32) for c in clean]
    if zero_rows:
        adv[0][1] = 0.0  # an all-zero frame hits the 1e-8 norm clamp
        adv[1][4] = 0.0
    return adv, clean


@pytest.mark.parametrize("zero_rows", [False, True])
def test_cosine_similarity_flat_matches_jax(zero_rows):
    adv, clean = _pair(5, zero_rows)
    a, b = adv[0], clean[0]
    want = np.asarray(jlosses.cosine_similarity_flat(jnp.asarray(a), jnp.asarray(b)))
    got = losses.cosine_similarity_flat(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if zero_rows:
        assert got[1] == 0.0


@pytest.mark.parametrize("weighted", [False, True])
def test_i2v_cost_matches_jax(weighted):
    adv, clean = _pair(7, zero_rows=True)
    w = np.asarray([1, 1, 0, 1, 0.5, 1], np.float32) if weighted else None
    want = float(jlosses.i2v_cost([jnp.asarray(t) for t in adv], [jnp.asarray(t) for t in clean],
                                  None if w is None else jnp.asarray(w)))
    got = float(losses.i2v_cost([torch.from_numpy(t) for t in adv],
                                [torch.from_numpy(t) for t in clean],
                                None if w is None else torch.from_numpy(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_per_tap_frame_cosines_match_jax():
    adv, clean = _pair(9)
    want = np.asarray(jlosses.per_tap_frame_cosines([jnp.asarray(t) for t in adv],
                                                    [jnp.asarray(t) for t in clean]))
    got = losses.per_tap_frame_cosines([torch.from_numpy(t) for t in adv],
                                       [torch.from_numpy(t) for t in clean]).numpy()
    assert got.shape == (2, 6)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _grad_with_zero_slices_and_nan(nan: bool):
    g = (_clip(11, (3, 3, 4, 8, 8)) - 0.5) * 1e-3
    g[0, :, 1] = 0.0      # one all-zero frame of clip 0
    g[1] = 0.0            # all of clip 1
    if nan:
        g[2, 1, 2, 3, 4] = np.nan
    return g


@pytest.mark.parametrize("frame_level", [True, False])
@pytest.mark.parametrize("nan", [False, True])
def test_norm_grads_matches_jax_with_zero_slices_and_nan(frame_level, nan):
    g = _grad_with_zero_slices_and_nan(nan)
    want = np.asarray(jgrads.norm_grads(jnp.asarray(g), frame_level=frame_level))
    got = grads.norm_grads(torch.from_numpy(g), frame_level=frame_level).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)  # NaN must meet NaN
    assert (got[1] == 0).all() and np.isfinite(got[:2]).all()
    if frame_level:
        assert (got[0, :, 1] == 0).all()
    assert np.isnan(got[2]).any() == nan
    with pytest.raises(ValueError):
        grads.norm_grads(torch.from_numpy(g[0]))


@pytest.mark.parametrize("nan", [False, True])
def test_l1_normalize_matches_jax(nan):
    g = _grad_with_zero_slices_and_nan(nan)
    want = np.asarray(jgrads.l1_normalize(jnp.asarray(g)))
    got = grads.l1_normalize(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isnan(got).all() == nan
    assert (grads.l1_normalize(torch.zeros(2, 3)) == 0).all()


def test_cross_entropy_matches_jax():
    rng = np.random.RandomState(12)
    logits = (rng.randn(5, 400) * 8).astype(np.float32)
    labels = rng.randint(0, 400, size=5)
    want = float(jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
