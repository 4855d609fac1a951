"""The port's I3D against the JAX package's, and the video-model registry.

Weights go JAX → port through ``from_jax_params``; inputs are numpy draws.
Logits and every ``res_layer`` tap agree to rtol/atol 1e-5 relative to the
tensor's scale with the JAX side in float32 precision (tests/conftest.py
pins it): the two frameworks sum the convs and the attention products in
different orders, ~1e-7 relative a sum. The input gradient at a generic
point agrees to atol 1e-5·max|g| for the same reason, through the backward
as well. At full width only the parameter sets are compared (no full-width
forward runs on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.models import i3d as ji3d  # noqa: E402
from i2v_tpu.ops import activations as jactivations  # noqa: E402
from i2v_tpu_torch.models import VideoModel, get_video_model, tap_keys_for  # noqa: E402
from i2v_tpu_torch.models import i3d, registry, video_zoo  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402
from i2v_tpu_torch.ops import activations, pixel  # noqa: E402

CLIP = (2, 3, 8, 32, 32)
TAPS = ("res_layer1", "res_layer2", "res_layer3", "res_layer4")


def _clip(seed):
    return np.random.RandomState(seed).rand(*CLIP).astype(np.float32)


def _pair(seed=0, **kw):
    jmod = ji3d.i3d_tiny(**kw)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + CLIP[1:])))
    return jmod, params, from_jax_params(i3d.i3d_tiny(**kw), params).eval()


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("sub_sample", [True, False])
@pytest.mark.parametrize("nl_type", ["gaussian", "dot"])
def test_tiny_logits_and_taps_match_jax(sub_sample, nl_type):
    jmod, params, pmod = _pair(nl_sub_sample=sub_sample, nl_type=nl_type)
    x = _clip(1)
    jlogits, jtaps = jmod.apply(params, jnp.asarray(x))
    with torch.no_grad():
        logits, taps = pmod(torch.from_numpy(x))
    assert sorted(taps) == sorted(jtaps) == sorted(TAPS)
    for k in TAPS:
        # the port's taps are NCDHW, the JAX package's channel-last
        _close(taps[k].numpy().transpose(0, 2, 3, 4, 1), np.asarray(jtaps[k]), 1e-5)
    _close(logits.numpy(), np.asarray(jlogits), 1e-5)


def test_normalize_off_is_the_forward_on_a_normalized_clip():
    jmod, params, pmod = _pair()
    x = _clip(2)
    xn = np.asarray(pixel.normalize(torch.from_numpy(x), channel_axis=1))
    jl, _ = jmod.clone(normalize=False).apply(params, jnp.asarray(xn))
    with torch.no_grad():
        on, _ = pmod(torch.from_numpy(x))
        off, _ = pmod(torch.from_numpy(xn), normalize=False)
    np.testing.assert_array_equal(on.numpy(), off.numpy())
    _close(off.numpy(), np.asarray(jl), 1e-5)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_input_gradient_matches_jax(scale):
    """CE input gradient at a generic clip, with and without SGM's ReLU
    gradient scaling (stem and block-0 ReLUs unscaled on both sides)."""
    from i2v_tpu.ops import losses as jlosses

    jmod, params, pmod = _pair(seed=3)
    x = _clip(4)
    labels = np.asarray([1, 7])
    jm = jmod.clone(relu_grad_scale=scale)
    want = np.asarray(jax.grad(lambda c: jlosses.cross_entropy(
        jm.apply(params, c)[0], jnp.asarray(labels)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    logits, _ = pmod(xt, relu_grad_scale=scale)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    _close(xt.grad.numpy(), want, 1e-5)
    assert np.abs(want).max() > 0


def test_relu_grad_scale_changes_the_gradient_and_not_the_forward():
    _, _, pmod = _pair()
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


def test_grad_scaled_relu_matches_jax():
    x = np.random.RandomState(6).randn(4, 9).astype(np.float32)
    x[0, :3] = 0.0  # the mask is x > 0: zero passes no gradient
    g = np.random.RandomState(7).randn(4, 9).astype(np.float32)
    want_y, vjp = jax.vjp(lambda v: jactivations.grad_scaled_relu(v, 0.7), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = activations.grad_scaled_relu(xt, 0.7)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))


def test_from_jax_params_takes_5d_conv_kernels():
    w = np.arange(2 * 3 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 3, 4, 5)  # kT,kH,kW,I,O
    conv = torch.nn.Conv3d(4, 5, (2, 3, 3))
    holder = torch.nn.Module()
    holder.c = conv
    from_jax_params(holder, {"params": {"c": {"kernel": w, "bias": np.ones(5, np.float32)}}})
    np.testing.assert_array_equal(conv.weight.detach().numpy(), w.transpose(4, 3, 0, 1, 2))
    x = np.random.RandomState(8).rand(1, 4, 3, 5, 5).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)), jnp.asarray(w), (1, 1, 1), "VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=jax.lax.Precision.HIGHEST) + 1.0
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 4, 1)
    _close(got, np.asarray(want), 1e-5)


@pytest.mark.parametrize("name", ["i3d_resnet50", "i3d_resnet101"])
def test_full_width_parameter_sets_match_jax(name):
    jmod = {"i3d_resnet50": ji3d.i3d_resnet50, "i3d_resnet101": ji3d.i3d_resnet101}[name]()
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


@pytest.mark.parametrize("name", ["i3d_resnet50", "i3d_resnet101", "slowfast_resnet50",
                                  "slowfast_resnet101", "tpn_resnet50", "tpn_resnet101"])
def test_registry_builds_every_reference_model_and_refuses_unknown_ones(name):
    from i2v_tpu_torch.utils import VIDEO_MODEL_NAMES

    # the reference's six, and Video Swin-B, MViTv2-B and UniFormer-B, evaluated
    # only where named
    assert sorted(video_zoo.VIDEO_BUILDERS) == sorted(video_zoo.TINY_BUILDERS) == \
        sorted(VIDEO_MODEL_NAMES + ("swin3d_b", "mvit_v2_b", "uniformer_b"))
    bundle = get_video_model(name, device="cpu", tiny=True)
    with torch.no_grad():
        assert bundle.apply01(torch.from_numpy(_clip(11))).shape == (CLIP[0], 10)
    # the 101-class head of the UCF-101 models is a full-width option only
    assert get_video_model(name, device="cpu", tiny=True, ucf101=True).module.fc.out_features == 10
    with pytest.raises(ValueError, match="unknown video model"):
        get_video_model("c3d_resnet50", device="cpu")


def test_tiny_bundle_is_frozen_seeded_and_taps_the_tap_table():
    a = get_video_model("i3d_resnet50", device="cpu", tiny=True, seed=4)
    b = get_video_model("i3d_resnet101", device="cpu", tiny=True, seed=4)
    c = get_video_model("i3d_resnet50", device="cpu", tiny=True, seed=5)
    assert isinstance(a, VideoModel) and not a.module.training
    assert not any(p.requires_grad for p in a.module.parameters())
    assert a.tap_keys == tap_keys_for("i3d_resnet50") == ("res_layer1", "res_layer2")
    assert tap_keys_for("i3d_resnet50", "ilaf") == ("res_layer2",)
    for (n, p), (_, q), (_, r) in zip(a.module.named_parameters(), b.module.named_parameters(),
                                      c.module.named_parameters()):
        assert torch.equal(p, q), n
        if n.endswith("weight"):
            assert not torch.equal(p, r), n
    x = torch.from_numpy(_clip(9))
    with torch.no_grad():
        logits, taps = a.apply01_taps(x)
        assert [t.shape[1] for t in taps] == [32, 64]
        torch.testing.assert_close(a.apply_norm(pixel.normalize(x, channel_axis=1)), logits,
                                   rtol=0, atol=0)
        assert a.with_taps(["res_layer4"]).apply01_taps(x)[1][0].shape[1] == 256
    scaled = a.with_relu_grad_scale(0.5)
    assert scaled.module is a.module and scaled.relu_grad_scale == 0.5


def test_random_init_draws_conv3d_weights_at_fan_in_variance():
    conv = torch.nn.Conv3d(16, 64, (3, 3, 3))
    registry.random_init_(conv, torch.Generator().manual_seed(0))
    fan_in = 16 * 27
    assert abs(float(conv.weight.detach().std()) ** 2 * fan_in - 1.0) < 0.05
    assert float(conv.weight.detach().abs().max()) <= 2 / registry._TRUNC_STD_CORRECTION / fan_in**0.5
    assert torch.count_nonzero(conv.bias) == 0
