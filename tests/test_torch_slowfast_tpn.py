"""The port's SlowFast and TPN against the JAX package's.

Weights go JAX → port through ``from_jax_params``; inputs are numpy draws.
Tolerances are those of the I3D tests (tests/test_torch_video_models.py):
logits and every tap within rtol/atol 1e-5 of the tensor's scale, the CE
input gradient within atol 1e-5·max|g|, since the two frameworks sum the
convs in different orders (~1e-7 relative a sum). The JAX modules and
parameters are built once a module (their first trace is the slow part on
the CPU). At full width only the parameter sets are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.models import slowfast as jslowfast  # noqa: E402
from i2v_tpu.models import tpn as jtpn  # noqa: E402
from i2v_tpu.ops import losses as jlosses  # noqa: E402
from i2v_tpu_torch.models import get_video_model, slowfast, tpn, video_zoo  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402

CLIP = (2, 3, 8, 32, 32)
TAPS = {"slowfast": tuple(f"{p}_res{i}" for p in ("slow", "fast") for i in range(2, 6)),
        "tpn": ("layer1", "layer2", "layer3", "layer4")}
BUILDERS = {"slowfast": (jslowfast.slowfast_tiny, slowfast.slowfast_tiny),
            "tpn": (jtpn.tpn_tiny, tpn.tpn_tiny)}
# a SlowFast that skips frames: fast takes every 2nd frame, slow every 8th
STRIDED = dict(stage_sizes=(1, 2, 1, 1), width=8, beta_inv=4, fast_stride=2, slow_stride=8,
               num_classes=10)


def _clip(seed, shape=CLIP):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _build(jmod, pmod, shape, seed):
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + shape[1:])))
    return jmod, params, from_jax_params(pmod, params).eval()


@pytest.fixture(scope="module")
def pairs():
    return {family: _build(jb(), pb(), CLIP, seed)
            for seed, (family, (jb, pb)) in enumerate(BUILDERS.items())}


@pytest.fixture(scope="module")
def strided():
    return _build(jslowfast.SlowFast(**STRIDED), slowfast.SlowFast(**STRIDED),
                  (1, 3, 16, 32, 32), 7)


def _jax_ce_grad(jmod, params, x, labels, scale):
    jm = jmod.clone(relu_grad_scale=scale)
    grad = jax.jit(jax.grad(lambda p, c, y: jlosses.cross_entropy(jm.apply(p, c)[0], y),
                            argnums=1))
    return np.asarray(grad(params, jnp.asarray(x), jnp.asarray(labels)))


def _port_ce_grad(pmod, x, labels, scale):
    xt = torch.from_numpy(x).requires_grad_(True)
    logits, _ = pmod(xt, relu_grad_scale=scale)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    return xt.grad.numpy()


@pytest.mark.parametrize("family", ["slowfast", "tpn"])
def test_tiny_logits_and_taps_match_jax(pairs, family):
    jmod, params, pmod = pairs[family]
    x = _clip(1)
    jlogits, jtaps = jax.jit(jmod.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        logits, taps = pmod(torch.from_numpy(x))
    assert sorted(taps) == sorted(jtaps) == sorted(TAPS[family])
    for k in TAPS[family]:
        # the port's taps are NCDHW, the JAX package's channel-last
        _close(taps[k].numpy().transpose(0, 2, 3, 4, 1), np.asarray(jtaps[k]), 1e-5)
    _close(logits.numpy(), np.asarray(jlogits), 1e-5)


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("family", ["slowfast", "tpn"])
def test_input_gradient_matches_jax(pairs, family, scale):
    """CE input gradient at a generic clip, with and without SGM's ReLU
    gradient scaling (which ReLUs it reaches differs between the two
    families: TPN's stem and its coarse level fusion are scaled)."""
    jmod, params, pmod = pairs[family]
    x, labels = _clip(4), np.asarray([1, 7])
    want = _jax_ce_grad(jmod, params, x, labels, scale)
    _close(_port_ce_grad(pmod, x, labels, scale), want, 1e-5)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("family", ["slowfast", "tpn"])
def test_relu_grad_scale_changes_the_gradient_and_not_the_forward(pairs, family):
    _, _, pmod = pairs[family]
    x = torch.from_numpy(_clip(5))
    grads, outs = [], []
    for scale in (1.0, 0.3):
        xt = x.clone().requires_grad_(True)
        logits, _ = pmod(xt, relu_grad_scale=scale)
        logits.sum().backward()
        grads.append(xt.grad)
        outs.append(logits.detach())
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert (grads[0] - grads[1]).abs().max() > 1e-3 * grads[0].abs().max()


def test_strided_slowfast_gives_unsampled_frames_exactly_zero_gradient(strided):
    jmod, params, pmod = strided
    x, labels = _clip(6, (1, 3, 16, 32, 32)), np.asarray([3])
    want = _jax_ce_grad(jmod, params, x, labels, 1.0)
    got = _port_ce_grad(pmod, x, labels, 1.0)
    _close(got, want, 1e-5)
    # frames 1, 3, …: neither pathway samples them (fast ::2, slow ::8)
    assert not want[:, :, 1::2].any() and not got[:, :, 1::2].any()
    assert all(np.abs(got[:, :, t]).max() > 0 for t in range(0, 16, 2))


def test_grouped_conv_weight_transfer():
    """Flax's grouped kernel (kT,kH,kW,I/g,O) maps to torch's (O,I/g,kT,kH,kW)
    through from_jax_params' 5-D transpose, and the convs agree."""
    from i2v_tpu.models.video_common import conv3d as jconv3d
    from i2v_tpu_torch.models.video_common import conv3d

    jconv = jconv3d(12, (3, 1, 1), groups=4)
    x = _clip(8, (2, 8, 5, 3, 3))
    params = jax.tree_util.tree_map(np.asarray, jconv.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5, 3, 3, 8))))
    params["params"]["bias"] = np.random.RandomState(9).randn(12).astype(np.float32)
    assert params["params"]["kernel"].shape == (3, 1, 1, 2, 12)
    holder = torch.nn.Module()
    holder.c = conv3d(8, 12, (3, 1, 1), groups=4)
    from_jax_params(holder, {"params": {"c": params["params"]}})
    assert tuple(holder.c.weight.shape) == (12, 2, 3, 1, 1)
    want = jconv.apply(params, jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    with torch.no_grad():
        got = holder.c(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 4, 1)
    _close(got, np.asarray(want), 1e-5)


@pytest.mark.parametrize("t,s", [(5, 2), (7, 3), (6, 2), (4, 1)])
def test_pool_t_ceil_matches_jax_and_ceil_mode_max_pool(t, s):
    x = np.random.RandomState(t * 10 + s).randn(2, 3, t, 2, 2).astype(np.float32)
    got = tpn._pool_t_ceil(torch.from_numpy(x), s).numpy()
    want = np.asarray(jtpn._pool_t_ceil(jnp.asarray(x.transpose(0, 2, 3, 4, 1)), s))
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 4, 1), want)
    assert got.shape[2] == -(-t // s)
    if s > 1:
        np.testing.assert_array_equal(got, torch.nn.functional.max_pool3d(
            torch.from_numpy(x), (s, 1, 1), (s, 1, 1), ceil_mode=True).numpy())


@pytest.mark.parametrize("name", ["slowfast_resnet50", "slowfast_resnet101",
                                  "tpn_resnet50", "tpn_resnet101"])
def test_full_width_parameter_sets_match_jax(name):
    jmod = {"slowfast_resnet50": jslowfast.slowfast_resnet50,
            "slowfast_resnet101": jslowfast.slowfast_resnet101,
            "tpn_resnet50": jtpn.tpn_resnet50, "tpn_resnet101": jtpn.tpn_resnet101}[name]()
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 3, 32, 224, 224), jnp.float32))
    flat = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    pmod = video_zoo.VIDEO_BUILDERS[name]()
    assert len(list(pmod.parameters())) == len(flat)
    for pname, p in pmod.named_parameters():
        owner, kind = pname.rsplit(".", 1)
        jshape = flat[f"{owner}.{'kernel' if kind == 'weight' else kind}"]
        want = (jshape[-1], jshape[-2]) + tuple(jshape[:-2]) if len(jshape) == 5 else \
            tuple(reversed(jshape))
        assert tuple(p.shape) == want, pname
    assert sum(p.numel() for p in pmod.parameters()) == \
        sum(int(np.prod(s)) for s in flat.values())


@pytest.mark.parametrize("family", ["slowfast", "tpn"])
def test_tiny_bundles_tap_the_tap_table(family):
    b = get_video_model(f"{family}_resnet50", device="cpu", tiny=True, seed=2)
    assert b.tap_keys == video_zoo.TAP_TAPS[family]
    with torch.no_grad():
        logits, taps = b.apply01_taps(torch.from_numpy(_clip(10)))
    assert logits.shape == (2, 10) and len(taps) == len(b.tap_keys)
    assert all(bool(torch.isfinite(t).all()) for t in taps)
