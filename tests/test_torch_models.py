"""The port's image backbones against the JAX package's.

Weights go JAX → port through ``from_jax_params``; inputs are numpy draws.
Taps and logits agree to rtol/atol 1e-5 with the JAX side in float32
precision (tests/conftest.py pins it): the two frameworks sum the convs in
different orders. At full width only the parameter sets are compared (no
full-width forward runs on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.models import common as jcommon  # noqa: E402
from i2v_tpu.models import registry as jregistry  # noqa: E402
from i2v_tpu.models import resnet as jresnet  # noqa: E402
from i2v_tpu.models import vgg as jvgg  # noqa: E402
from i2v_tpu_torch.models import common, registry, resnet, vgg  # noqa: E402
from i2v_tpu_torch.models.api import ImageModel  # noqa: E402
from i2v_tpu_torch.models.convert import fold_bn, from_jax_params  # noqa: E402

HW = 64

# (JAX module, port module) pairs at test widths, with every tap of the
# reference's depth table
TINY = {
    "resnet_tiny": (lambda **kw: jresnet.resnet_tiny(**kw),
                    lambda **kw: resnet.resnet_tiny(**kw), (1, 2, 3, 4)),
    "vgg16_x0.125": (lambda **kw: jvgg.VGG16(width_mult=0.125, **kw),
                     lambda **kw: vgg.VGG16(width_mult=0.125, input_hw=HW, **kw),
                     (1, 11, 20, 29)),
    "alexnet_x0.125": (lambda **kw: jvgg.AlexNet(width_mult=0.125, **kw),
                       lambda **kw: vgg.AlexNet(width_mult=0.125, input_hw=HW, **kw),
                       (1, 4, 7, 11)),
    "squeezenet_x0.25": (lambda **kw: jvgg.SqueezeNet11(width_mult=0.25, **kw),
                         lambda **kw: vgg.SqueezeNet11(width_mult=0.25, **kw),
                         (3, 6, 9, 12)),
    "squeezenet_x0.25_fire": (
        lambda **kw: jvgg.SqueezeNet11(width_mult=0.25, fire_taps=True, **kw),
        lambda **kw: vgg.SqueezeNet11(width_mult=0.25, fire_taps=True, **kw),
        (3, 6, 9, 12)),
}


def _frames(seed, n=2, hw=HW):
    return np.random.RandomState(seed).rand(n, hw, hw, 3).astype(np.float32)


def _pair(key, truncate, taps=None, seed=0):
    jmake, pmake, all_taps = TINY[key]
    taps = all_taps if taps is None else taps
    jmod = jmake(taps=taps, truncate=truncate)
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 3))))
    pmod = from_jax_params(pmake(taps=taps, truncate=truncate), params)
    return jmod, params, pmod


@pytest.mark.parametrize("key", sorted(TINY))
def test_tiny_taps_and_logits_match_jax(key):
    jmod, params, pmod = _pair(key, truncate=False)
    x = _frames(1)
    jlogits, jtaps = jmod.apply(params, jnp.asarray(x))
    with torch.no_grad():
        logits, taps = pmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(taps) == sorted(jtaps)
    for k in jtaps:
        np.testing.assert_allclose(taps[k].numpy().transpose(0, 2, 3, 1),
                                   np.asarray(jtaps[k]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", sorted(TINY))
def test_truncation_returns_no_logits_and_builds_nothing_deeper(key):
    shallow = (TINY[key][2][1],)
    jmod, params, pmod = _pair(key, truncate=True, taps=shallow)
    x = _frames(2)
    jlogits, jtaps = jmod.apply(params, jnp.asarray(x))
    with torch.no_grad():
        logits, taps = pmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert logits is None and jlogits is None
    assert list(taps) == list(shallow)
    np.testing.assert_allclose(taps[shallow[0]].numpy().transpose(0, 2, 3, 1),
                               np.asarray(jtaps[shallow[0]]), rtol=1e-5, atol=1e-5)
    # from_jax_params has already matched the parameter sets one to one;
    # the full module has strictly more
    full = TINY[key][1](taps=TINY[key][2], truncate=False)
    assert sum(p.numel() for p in pmod.parameters()) < sum(p.numel() for p in full.parameters())
    with pytest.raises(ValueError, match="truncated"):
        ImageModel(key, pmod, shallow).apply01(torch.zeros(1, 3, HW, HW))


@pytest.mark.parametrize("size", [224, 111, 55, 27, 64, 31, 15, 7, 32, 3])
def test_ceil_mode_pool_matches_jax_padding(size):
    x = np.random.RandomState(size).randn(2, size, size, 4).astype(np.float32)
    for kernel, stride, padding, ceil in ((3, 2, 0, True), (3, 2, 1, False), (2, 2, 0, False),
                                          (3, 2, 0, False)):
        want = np.asarray(jcommon.max_pool(jnp.asarray(x), kernel, stride, padding, ceil))
        got = common.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), kernel, stride,
                              padding, ceil).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(got, want)


def test_squeezenet_ceil_pool_sizes():
    sizes = []
    x = torch.zeros(1, 1, 224, 224)
    x = torch.nn.functional.conv2d(x, torch.zeros(1, 1, 3, 3), stride=2)
    sizes.append(x.shape[-1])
    for _ in range(3):
        x = common.max_pool(x, 3, 2, ceil_mode=True)
        sizes.append(x.shape[-1])
    assert sizes == [111, 55, 27, 13]


ENS = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}


@pytest.mark.parametrize("name", sorted(ENS))
def test_full_width_parameters_match_jax_one_to_one(name):
    """The slice's surrogates at full width, truncated at their ENS depths:
    every port parameter takes a Flax parameter of its shape, and no Flax
    parameter is left over."""
    jmod, jtaps = jregistry.build_image_model(name, ENS[name], truncate=True)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    pmod, taps = registry.build_image_model(name, ENS[name], truncate=True)
    assert taps == jtaps
    from_jax_params(pmod, params)
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in pmod.parameters())
    assert all(int(torch.count_nonzero(p)) == 0 for p in pmod.parameters())


def test_from_jax_params_refuses_mismatches():
    jmod, params, pmod = _pair("resnet_tiny", truncate=True, taps=(2,))
    extra = {"params": dict(params["params"], surplus={"kernel": np.zeros((1, 1))})}
    with pytest.raises(KeyError, match="surplus"):
        from_jax_params(pmod, extra)
    wrong = jax.tree_util.tree_map(lambda a: np.zeros(a.shape + (1,), a.dtype), params)
    with pytest.raises(ValueError):
        from_jax_params(pmod, wrong)


def test_fold_bn_matches_eval_mode_batchnorm():
    rng = np.random.RandomState(3)
    conv = torch.nn.Conv2d(3, 5, 3, padding=1)
    bn = torch.nn.BatchNorm2d(5).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.randn(5).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy((0.5 + rng.rand(5)).astype(np.float32)))
    w, b = fold_bn(conv.weight.detach().numpy(), conv.bias.detach().numpy(),
                   {f"bn.{k}": v for k, v in bn.state_dict().items()}, "bn")
    x = torch.from_numpy(rng.randn(2, 3, 8, 8).astype(np.float32))
    with torch.no_grad():
        want = bn(conv(x))
        got = torch.nn.functional.conv2d(x, torch.from_numpy(w), torch.from_numpy(b), padding=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_registry_seeded_init_and_unported_names():
    a = registry.get_image_models(["squeezenet"], 2, device="cpu", tiny=True, seed=4)[0]
    b = registry.get_image_models(["squeezenet"], 2, device="cpu", tiny=True, seed=4)[0]
    assert all(torch.equal(p, q) for p, q in zip(a.module.parameters(), b.module.parameters()))
    assert not any(p.requires_grad for p in a.module.parameters())
    assert not a.module.training

    with pytest.warns(UserWarning, match="no pretrained checkpoint"):
        full = registry.get_image_models(["squeezenet"], 2, device="cpu", seed=4)[0]
        other = registry.get_image_models(["squeezenet"], 2, device="cpu", seed=5)[0]
    assert not torch.equal(full.module.conv0.weight, other.module.conv0.weight)

    # densenet and vit build with the JAX tap tables;
    # an unknown name is still refused
    for name, taps in (("densenet", (2,)), ("vit", (5,))):
        module, got = registry.build_image_model(name, 2, tiny=False)
        assert got == taps and module.taps == taps and module.headless
    with pytest.raises(ValueError, match="unknown image model"):
        registry.build_image_model("inception", 2)
