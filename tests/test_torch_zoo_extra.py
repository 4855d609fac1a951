"""The port's DenseNet-161 and ViT-B/16 against the JAX package's.

Tiny variants carry the same weights (drawn by the port's seeded init,
crossed as a Flax tree through ``to_jax_params`` and read back into a fresh
port module by ``from_jax_params``) and see the same seeded numpy frames
(the JAX forward jitted, one compile a shape): logits and every
tap agree to rtol 1e-5 and atol 1e-5·max|·|, ViT at its canonical 32² and
at inputs that shrink (16²) and grow (48², and 36², which the patch does not
divide) its position grid. The
full-width modules are compared by parameter shapes only (``jax.eval_shape``
of the JAX init; the port's built on the meta device): no full-width
compute on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.models import registry as jregistry  # noqa: E402
from i2v_tpu_torch.models import build_image_model, get_image_models  # noqa: E402
from i2v_tpu_torch.models import registry  # noqa: E402
from i2v_tpu_torch.models.convert import (  # noqa: E402
    from_jax_params, load_params, save_params, to_jax_params)

RTOL = 1e-5


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def _twins(name, depths, truncate=False, seed=1):
    """A tiny JAX module with its Flax params and a port module carrying
    them."""
    jm, jtaps = jregistry.build_image_model(name, depths, tiny=True, truncate=truncate)
    seeded, _ = build_image_model(name, depths, tiny=True, truncate=truncate)
    params = {"params": to_jax_params(
        registry.random_init_(seeded, torch.Generator().manual_seed(seed)))}
    pm, ptaps = build_image_model(name, depths, tiny=True, truncate=truncate)
    assert ptaps == jtaps
    from_jax_params(pm, params)
    return jm, params, pm.eval().requires_grad_(False)


@pytest.mark.parametrize("name,depths,hw", [
    ("densenet", 4, 32),
    ("densenet", [1, 2], 40),
    ("vit", 4, 32),
    ("vit", [1, 4], 16),   # the 4x4 grid shrinks to 2x2: antialiased resize
    ("vit", 4, 48),        # and grows to 6x6
    ("vit", 4, 36),        # 36 = 4.5 patches: Flax's 'SAME' padding, a 5x5 grid
])
def test_tiny_logits_and_every_tap_match_jax(name, depths, hw):
    jm, params, pm = _twins(name, depths)
    x = np.random.RandomState(hw).rand(2, hw, hw, 3).astype(np.float32)
    jl, jtaps = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        pl, ptaps = pm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    _close(pl, jl)
    assert sorted(ptaps) == sorted(jtaps) and len(ptaps) == 2
    for k in jtaps:
        _close(_nhwc(ptaps[k]), jtaps[k])


@pytest.mark.parametrize("name", ["densenet", "vit"])
def test_truncated_equals_untruncated_at_the_taps(name):
    """The truncated module has no head and no block past its deepest tap;
    its taps are the untruncated module's, bit for bit."""
    _, params, whole = _twins(name, 1)
    cut, taps = build_image_model(name, 1, tiny=True, truncate=True)
    from_jax_params(cut, params, mode="subset")
    assert cut.headless and sum(p.numel() for p in cut.parameters()) < \
        sum(p.numel() for p in whole.parameters())
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        logits, got = cut(x)
        _, want = whole(x)
    assert logits is None and list(got) == [k for k in want if k <= max(taps)]
    for k in got:
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("name,depths", [
    ("densenet", [3, 4]), ("densenet", 4), ("densenet", [1, 2, 3]),
    ("vit", [2, 3]), ("vit", [1, 2, 3, 4]), ("vit", 1),
])
def test_tiny_taps_are_clamped_and_deduplicated_as_in_jax(name, depths):
    """The tiny DenseNet has 2 dense blocks, the tiny ViT 2 transformer
    blocks: deep taps clamp into range and repeats are dropped, in request
    order (tests/test_gradcam.py::TestTinyTapClamps)."""
    module, taps = build_image_model(name, depths, tiny=True)
    _, jtaps = jregistry.build_image_model(name, depths, tiny=True)
    assert taps == jtaps and len(set(taps)) == len(taps)
    lo, hi = (1, 2) if name == "densenet" else (0, 1)
    assert all(lo <= t <= hi for t in taps) and module.taps == taps


def _jax_layout_shape(shape):
    if len(shape) == 4:
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    if len(shape) == 2:
        return tuple(reversed(shape))
    return tuple(shape)


@pytest.mark.parametrize("name", ["densenet", "vit"])
def test_full_width_parameter_shapes_match_jax(name):
    """DenseNet-161 (6, 12, 36, 24; growth 48; 96 initial features) and
    ViT-B/16 (768 wide, 12 blocks, 12 heads): every parameter of the port
    module has the Flax leaf's shape under the converter's name, and the
    trees have the same leaves."""
    from i2v_tpu_torch.models.convert import _flax_key, _scale_owners

    jm, _ = jregistry.build_image_model(name, 4, truncate=False)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))["params"]
    want = {".".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    with torch.device("meta"):
        pm, _ = build_image_model(name, 4, truncate=False)
    owners = _scale_owners(pm)
    got = {_flax_key(n, owners): _jax_layout_shape(tuple(p.shape))
           for n, p in pm.named_parameters()}
    assert got == want
    n_params = sum(int(np.prod(s)) for s in want.values())
    # torchvision's 28,681,000 plus the conv biases the JAX module keeps; timm's
    assert n_params == {"densenet": 28_701_448, "vit": 86_567_656}[name]


@pytest.mark.parametrize("name,depths", [("densenet", 1), ("vit", 1)])
def test_jax_params_round_trip_and_a_saved_file_loads_through_the_registry(
        name, depths, tmp_path, monkeypatch):
    """``from_jax_params`` reads back what ``to_jax_params`` wrote, leaf for
    leaf (LayerNorm ``scale``, top-level ``cls_token`` and ``pos_embed``);
    a file written by ``save_params`` from a full-width module truncated one
    tap deeper loads, in ``subset`` mode, into the registry's full-width
    module, which then gives that module's taps (DenseNet-161's and
    ViT-B/16's topologies at small widths, to keep the files small)."""
    _, params, pm = _twins(name, [1, 4])
    fresh, _ = build_image_model(name, [1, 4], tiny=True, truncate=False)
    back = to_jax_params(from_jax_params(fresh, params))
    flat_j = {jax.tree_util.keystr(p): v
              for p, v in jax.tree_util.tree_leaves_with_path(params["params"])}
    flat_b = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert flat_j.keys() == flat_b.keys()
    for k, v in flat_j.items():
        assert np.array_equal(v, flat_b[k]), k

    monkeypatch.setenv("I2V_TPU_CKPTS", str(tmp_path))
    # the full-width builders' topologies at small widths: the same path, small files
    monkeypatch.setattr(registry._vit, "vit_base_patch16_224",
                        lambda **kw: registry._vit.ViT(dim=64, heads=4, **kw))
    monkeypatch.setattr(registry._densenet, "densenet161",
                        lambda **kw: registry._densenet.DenseNet(growth=8, init_features=16, **kw))
    deeper, _ = build_image_model(name, depths + 1, truncate=True)
    registry.random_init_(deeper, torch.Generator().manual_seed(123))
    save_params(to_jax_params(deeper), name)
    assert set(load_params(name)) == {n.split(".")[0] for n, _ in deeper.named_parameters()}
    (bundle,) = get_image_models([name], depths, device="cpu")
    x = torch.from_numpy(np.random.RandomState(5).rand(1, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        got = bundle.apply01_taps(x)[1][0]
        want = deeper(x)[1][bundle.tap_keys[0]]
    assert torch.equal(got, want)


def test_random_init_draws_norms_tokens_and_positions_as_flax_does():
    """Norms ones/zeros, the class token zeros, the position embedding a
    normal of std 0.02, from the seeded generator: the same seed gives the
    same weights."""
    pm, _ = build_image_model("vit", 1, tiny=True)
    a = registry.random_init_(pm, torch.Generator().manual_seed(0))
    pos = a.pos_embed.detach().clone()
    assert torch.equal(a.cls_token, torch.zeros_like(a.cls_token))
    assert torch.equal(a.block0.norm1.weight, torch.ones(32))
    assert abs(float(pos.std()) - 0.02) < 0.005
    registry.random_init_(pm, torch.Generator().manual_seed(0))
    assert torch.equal(pm.pos_embed, pos)
    dn, _ = build_image_model("densenet", 1, tiny=True)
    registry.random_init_(dn, torch.Generator().manual_seed(0))
    assert torch.equal(dn.norm0.scale, torch.ones(16)) and torch.equal(dn.norm0.bias,
                                                                        torch.zeros(16))
