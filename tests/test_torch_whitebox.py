"""The port's white-box sign attacks against the JAX package's, on i3d_tiny.

The same weights (JAX → port through ``from_jax_params``) and the same numpy
clips go through both attacks. Tolerances, with the reason for each: the
two frameworks sum convs and reductions in different orders, ~1e-7
relative a sum, so
  - the step-0 cost agrees to rtol 1e-5 and the step-0 input gradient to
    atol 1e-5·max|g|;
  - the per-step cost trajectories agree to rtol 1e-5;
  - the adversarial clips may differ only where a gradient's sign flips
    because |g| is within that error of 0: at most 0.1% of the elements.
The port's own exactness claims (``batch_chunk``, SIM's ``batch_scales``,
SGM at γ=1) are held as the JAX package's tests hold its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

import i2v_tpu.attacks as jattacks  # noqa: E402
from i2v_tpu.models import i3d as ji3d  # noqa: E402
from i2v_tpu.models.api import VideoModel as JVideoModel  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.attacks.core import _chunked  # noqa: E402
from i2v_tpu_torch.models import VideoModel, i3d  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402
from i2v_tpu_torch.ops import kernels, losses, pixel  # noqa: E402

EPS = 16 / 255
CLIP = (2, 3, 8, 32, 32)
LABELS = np.asarray([1, 3])
TAPS = ("res_layer1", "res_layer2")
COST_RTOL = 1e-5
GRAD_ATOL = 1e-5
PIXEL_SHARE = 1e-3

# name → the attack, built from a package's attacks module (JAX or port) on a bundle
ATTACKS = {
    "FGSM": lambda mod, m: mod.FGSM(m),
    "BIM": lambda mod, m: mod.BIM(m, steps=4),
    "MIFGSM": lambda mod, m: mod.MIFGSM(m, steps=4),
    "SGM": lambda mod, m: mod.SGM(m, steps=4, gamma=0.2),
    "SIM": lambda mod, m: mod.SIM(m, steps=2, scale_steps=3),
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


def _costs(atk, name="v"):
    return np.asarray([float(atk.loss_info[name][i]["cost"])
                       for i in range(len(atk.loss_info[name]))])


def _check_invariants(adv_norm, videos_norm):
    adv01 = pixel.unnormalize(torch.as_tensor(adv_norm), channel_axis=1).numpy()
    clean01 = pixel.unnormalize(torch.as_tensor(videos_norm), channel_axis=1).numpy()
    assert adv01.min() >= -1e-5 and adv01.max() <= 1 + 1e-5
    assert np.abs(adv01 - clean01).max() <= EPS + 1e-5


@pytest.mark.parametrize("name", sorted(ATTACKS))
def test_step0_cost_and_gradient_match_jax(bundles, videos, name):
    jb, pb = bundles
    jatk, patk = ATTACKS[name](jattacks, jb), ATTACKS[name](attacks, pb)
    clean01 = np.array(jpixel.unnormalize(jnp.asarray(videos), channel_axis=1))
    jcost, jg = jax.jit(jatk._build_grad_fn(jatk.model))(
        jnp.asarray(clean01), jnp.asarray(LABELS), jax.random.PRNGKey(0))
    pcost, pg = patk._build_grad_fn(patk.model)(torch.from_numpy(clean01),
                                                torch.from_numpy(LABELS), None)
    np.testing.assert_allclose(float(pcost), float(jcost), rtol=COST_RTOL)
    scale = float(np.abs(np.asarray(jg)).max())
    assert scale > 0
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0, atol=GRAD_ATOL * scale)


@pytest.mark.parametrize("name", sorted(ATTACKS))
def test_attack_matches_jax(bundles, videos, name):
    jb, pb = bundles
    jatk, patk = ATTACKS[name](jattacks, jb), ATTACKS[name](attacks, pb)
    jadv = np.asarray(jatk(jnp.asarray(videos), jnp.asarray(LABELS), video_names=["v"]))
    kernels.reset_launches()
    padv = patk(videos, LABELS, ["v"]).numpy()
    # on the CPU the wrapper takes the plain version and launches nothing
    assert kernels.launches["sign_step"] == 0
    _check_invariants(padv, videos)
    jc, pc = _costs(jatk), _costs(patk)
    assert len(pc) == patk.steps == jatk.steps
    np.testing.assert_allclose(pc, jc, rtol=COST_RTOL)
    if len(pc) > 1:
        assert pc[-1] > pc[0]  # the CE cost is ascended
    assert np.mean(padv != jadv) <= PIXEL_SHARE
    # a flipped pixel is at most 2ε away in [0,1]
    np.testing.assert_allclose(padv, jadv, rtol=0, atol=2 * EPS / min(pixel.IMAGENET_STD))


@pytest.mark.parametrize("method,batch,chunk", [("BIM", 2, 1), ("MIFGSM", 2, 1), ("BIM", 3, 2)])
def test_batch_chunk_attack_matches_full_batch(bundles, videos, method, batch, chunk):
    """Gradient accumulation over clip-batch chunks reproduces the
    full-batch attack; a chunk that does not divide the batch snaps to the
    largest divisor that fits (3 clips, chunk 2 → chunks of 1). The cases
    of the JAX package's own test, at its tolerance."""
    _, pb = bundles
    v = np.concatenate([videos, videos[:1]])[:batch]
    labels = np.concatenate([LABELS, LABELS[:1]])[:batch]
    full = getattr(attacks, method)(pb, steps=3)
    chunked = getattr(attacks, method)(pb, steps=3)
    chunked.cfg = dataclasses.replace(chunked.cfg, batch_chunk=chunk)
    np.testing.assert_allclose(chunked(v, labels).numpy(), full(v, labels).numpy(), atol=2e-6)


@pytest.mark.parametrize("batch,chunk", [(2, 1), (3, 2), (4, 2)])
def test_batch_chunk_gradient_is_exact(bundles, videos, batch, chunk):
    """At the gradient level, where no sign step amplifies the rounding of
    the 1/k rescale: the chunked cost and gradient are the full batch's to
    float32 rounding."""
    _, pb = bundles
    v = np.concatenate([videos, videos])[:batch]
    clean01 = pixel.unnormalize(torch.from_numpy(v), channel_axis=1)
    labels = torch.from_numpy(np.concatenate([LABELS, LABELS])[:batch])
    grad_fn = attacks.make_ce_grad_fn(pb.apply_norm)
    cost, g = grad_fn(clean01, labels, None)
    ccost, cg = _chunked(grad_fn, batch, chunk)(clean01, labels, None)
    np.testing.assert_allclose(float(ccost), float(cost), rtol=1e-6)
    np.testing.assert_allclose(cg.numpy(), g.numpy(), rtol=0, atol=1e-5 * float(g.abs().max()))


def test_sim_batch_scales_matches_the_scale_loop(bundles, videos):
    _, pb = bundles
    clean01 = pixel.unnormalize(torch.from_numpy(videos), channel_axis=1)
    got = {}
    for flag in (False, True):
        atk = attacks.SIM(pb, steps=1, scale_steps=3, batch_scales=flag)
        got[flag] = atk._build_grad_fn(pb)(clean01, torch.from_numpy(LABELS), None)
    np.testing.assert_allclose(float(got[True][0]), float(got[False][0]), rtol=1e-5)
    scale = float(got[False][1].abs().max())
    np.testing.assert_allclose(got[True][1].numpy(), got[False][1].numpy(), atol=1e-5 * scale)


def test_sgm_at_gamma_one_is_bim(bundles, videos):
    _, pb = bundles
    a = attacks.SGM(pb, steps=3, gamma=1.0)(videos, LABELS)
    b = attacks.BIM(pb, steps=3)(videos, LABELS)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fgsm_is_one_full_epsilon_step(bundles, videos):
    _, pb = bundles
    atk = attacks.FGSM(pb, steps=7)
    assert atk.steps == 1 and atk.step_size == EPS
    adv01 = pixel.unnormalize(atk(videos, LABELS), channel_axis=1)
    clean01 = pixel.unnormalize(torch.from_numpy(videos), channel_axis=1)
    _, g = atk._build_grad_fn(pb)(clean01, torch.from_numpy(LABELS), None)
    want = pixel.sign_step_project(clean01, g, clean01, float(np.float32(EPS)),
                                   float(np.float32(EPS)))
    torch.testing.assert_close(adv01, pixel.unnormalize(pixel.normalize(want, channel_axis=1),
                                                        channel_axis=1), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["targeted", "least_likely"])
def test_attack_modes_match_jax(bundles, videos, mode):
    jb, pb = bundles
    jatk, patk = jattacks.BIM(jb, steps=3), attacks.BIM(pb, steps=3)
    if mode == "targeted":
        jatk.set_attack_mode(mode, lambda imgs, l: (l + 1) % 10)
        patk.set_attack_mode(mode, lambda imgs, l: (l + 1) % 10)
    else:
        jatk.set_attack_mode(mode)
        patk.set_attack_mode(mode)
    clean01 = pixel.unnormalize(torch.from_numpy(videos), channel_axis=1)
    jlab = np.asarray(jatk._transform_labels(jnp.asarray(clean01.numpy()), jnp.asarray(LABELS)))
    plab = patk._transform_labels(clean01, torch.from_numpy(LABELS).long())
    np.testing.assert_array_equal(plab.numpy(), jlab)
    jadv = np.asarray(jatk(jnp.asarray(videos), jnp.asarray(LABELS), video_names=["v"]))
    padv = patk(videos, LABELS, ["v"]).numpy()
    _check_invariants(padv, videos)
    np.testing.assert_allclose(_costs(patk), _costs(jatk), rtol=COST_RTOL)
    assert np.mean(padv != jadv) <= PIXEL_SHARE
    # attacking toward the target: the cost (−CE of the target) rises
    target = torch.from_numpy(np.array(jlab)).long()
    with torch.no_grad():
        ce = [float(losses.cross_entropy(pb.apply_norm(torch.as_tensor(x)), target))
              for x in (videos, padv)]
    assert ce[1] < ce[0]


def test_invalid_modes_are_refused(bundles):
    atk = attacks.BIM(bundles[1], steps=1)
    with pytest.raises(ValueError):
        atk.set_attack_mode("bogus")
    with pytest.raises(ValueError):
        atk.set_attack_mode("targeted")  # no map function


def test_int_return_type_gives_uint8_pixels(bundles, videos):
    atk = attacks.BIM(bundles[1], steps=1)
    atk.set_return_type("int")
    out = atk(videos, LABELS)
    assert out.dtype == torch.uint8 and out.shape == CLIP
