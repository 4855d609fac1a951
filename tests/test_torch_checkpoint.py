"""The port's flax-free checkpoint reader and writer, and the models that load
its files, against the JAX package and ``flax.serialization`` on the CPU.

Trees and file bytes compare bitwise. Model outputs compare as
tests/test_torch_video_models.py compares them: rtol/atol 1e-5 relative to
the tensor's scale (the two frameworks sum the convs in different orders).
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.models import convert as jconvert  # noqa: E402
from i2v_tpu.models import get_image_models as jget_image_models  # noqa: E402
from i2v_tpu.models import i3d as ji3d  # noqa: E402
from i2v_tpu.models import registry as jregistry  # noqa: E402
from i2v_tpu.models import video_zoo as jvideo_zoo  # noqa: E402
from i2v_tpu_torch.models import checkpoint, convert, i3d, registry, video_zoo  # noqa: E402
from i2v_tpu_torch.models import get_image_models, get_video_model  # noqa: E402

TOL = 1e-5


def _tree(seed):
    """A tree with every kind of leaf a checkpoint can hold."""
    rng = np.random.RandomState(seed)
    return {
        "conv": {"kernel": rng.rand(3, 3, 2, 4).astype(np.float32),
                 "bias": np.zeros(4, np.float32)},
        "ints": np.arange(300, dtype=np.int64).reshape(10, 30),
        "u8": rng.randint(0, 256, 7).astype(np.uint8),
        "half": rng.rand(5).astype(np.float16),
        "mask": np.array([True, False]),
        "pair": serialization.to_state_dict((rng.rand(2).astype(np.float32), 3)),
        "scalars": {"f32": np.float32(1.5), "i32": np.int32(-7), "zero_d": np.zeros((), np.float64)},
        "python": {"f": 0.25, "neg": -5, "big": -70000, "huge": 2 ** 40, "none": None,
                   "yes": True, "c": 1 + 2j, "s": "x" * 40, "b": b"abc" * 100,
                   "l": [1, 2.5, "z"]},
    }


def _same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("chunk", [None, 64])
def test_reader_and_writer_match_flax(tmp_path, monkeypatch, chunk):
    """A JAX-saved file (chunked, with a tuple node) restores as flax
    restores it; the port's file is flax's to the byte."""
    if chunk:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", chunk)
    tree = _tree(0)
    jpath = jconvert.save_params(tree, "mixed", str(tmp_path / "jax"))
    with open(jpath, "rb") as f:
        data = f.read()
    if chunk:
        assert b"__msgpack_chunked_array__" in data
    want = serialization.msgpack_restore(data)
    _same_tree(checkpoint.restore(data), want)
    _same_tree(convert.load_params("mixed", str(tmp_path / "jax")), want["params"])

    ppath = convert.save_params(tree, "mixed", str(tmp_path / "port"))
    with open(ppath, "rb") as f:
        pdata = f.read()
    assert os.path.basename(ppath) == "mixed.msgpack"
    assert pdata == data == serialization.msgpack_serialize({"params": tree})
    _same_tree(serialization.msgpack_restore(pdata), want)


def test_reader_refuses_what_it_cannot_read():
    good = checkpoint.serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.restore(good[:-2])
    # an array of a dtype numpy cannot name raises with the name
    header = checkpoint.packb([[2], "bfloat99", b"\0" * 4])
    bad = b"\x81\xa1a\xc7" + bytes([len(header)]) + b"\x01" + header
    with pytest.raises(ValueError, match="bfloat99"):
        checkpoint.restore(bad)
    with pytest.raises(TypeError, match="tuple"):
        checkpoint.serialize({"t": (1, 2)})


@pytest.mark.parametrize("name,depth", [("alexnet", 3), ("squeezenet", 2)])
def test_whole_network_file_loads_into_the_truncated_surrogate(name, depth):
    """A whole-network tree (what a converted file holds, here the port's
    ``to_jax_params`` of a seeded whole network, shaped as the JAX module's)
    loads into the port's module truncated at the deepest tap, as JAX
    applies its truncated module to the whole tree; the strict default
    refuses the extra leaves."""
    full, _ = registry.build_image_model(name, depth, truncate=False, tiny=True, input_hw=64)
    registry.random_init_(full, torch.Generator().manual_seed(6))
    tree = convert.to_jax_params(full)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    jfull, _ = jregistry.build_image_model(name, depth, truncate=False, tiny=True)
    shapes = jax.eval_shape(jfull.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    _same_tree(jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), tree),
               jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), shapes))
    jmod, taps = jregistry.build_image_model(name, depth, truncate=True, tiny=True)
    _, jtaps = jax.jit(jmod.apply)({"params": tree}, jnp.asarray(x))

    module, ptaps = registry.build_image_model(name, depth, truncate=True, tiny=True,
                                               input_hw=64)
    assert ptaps == taps
    with pytest.raises(KeyError, match="no port counterpart"):
        convert.from_jax_params(module, tree)
    convert.from_jax_params(module, tree, mode="subset")
    with torch.no_grad():
        _, got = module(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for k in taps:
        want = np.asarray(jtaps[k])
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got[k].numpy().transpose(0, 2, 3, 1), want, rtol=TOL,
                                   atol=TOL * scale)
    back, _ = registry.build_image_model(name, depth, truncate=False, tiny=True, input_hw=64)
    convert.from_jax_params(back, tree)
    for (k, p), (_, q) in zip(back.named_parameters(), full.named_parameters()):
        assert torch.equal(p, q), k


def test_registry_loads_a_full_width_file_without_the_random_init_warning(tmp_path,
                                                                         monkeypatch):
    monkeypatch.setenv("I2V_TPU_CKPTS", str(tmp_path))
    whole = get_image_models(["squeezenet"], 2, device="cpu", truncate=False, seed=7)[0]
    convert.save_params(convert.to_jax_params(whole.module), "squeezenet")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = get_image_models(["squeezenet"], 2, device="cpu", seed=0)[0]
    got = dict(loaded.module.named_parameters())
    for k, p in whole.module.named_parameters():
        if k in got:
            assert torch.equal(got[k], p), k
    assert len(got) < len(dict(whole.module.named_parameters()))  # truncated at the tap
    with pytest.warns(UserWarning) as record:
        get_image_models(["alexnet"], 3, device="cpu", tiny=False, input_hw=32)
    msg = f"no pretrained checkpoint for 'alexnet' under {str(tmp_path)!r}; using random init"
    assert any(str(w.message).startswith(msg) for w in record)


@pytest.fixture(scope="module")
def i3d_file(tmp_path_factory):
    """A full-width I3D-R50 file written by the JAX package's ``save_params``
    from seeded weights."""
    root = tmp_path_factory.mktemp("ckpts")
    module, gen = i3d.i3d_resnet50(), torch.Generator().manual_seed(11)
    with torch.no_grad():  # normal draws of variance 1/fan_in: cheaper than the truncated init
        for p in module.parameters():
            p.normal_(0.0, p[0].numel() ** -0.5 if p.ndim > 1 else 0.01, generator=gen)
    jconvert.save_params(convert.to_jax_params(module), "i3d_resnet50", str(root))
    return str(root)


def test_jax_saved_full_width_i3d_logits_match_jax(i3d_file, monkeypatch):
    monkeypatch.setenv("I2V_TPU_CKPTS", i3d_file)
    with open(os.path.join(i3d_file, "i3d_resnet50.msgpack"), "rb") as f:
        params = serialization.msgpack_restore(f.read())
    x = np.random.RandomState(2).rand(1, 3, 8, 32, 32).astype(np.float32)
    want = np.asarray(jax.jit(ji3d.i3d_resnet50().apply)(params, jnp.asarray(x))[0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bundle = get_video_model("i3d_resnet50", device="cpu", seed=5)
    with torch.no_grad():
        got = bundle.apply01(torch.from_numpy(x)).numpy()
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def test_partial_video_file_overlays_as_jax_does(tmp_path, monkeypatch):
    """A ``_ucf101`` file without some top-level modules is laid over the
    init in both packages, with the same warning. The JAX module's init is
    the port's seeded init here (its tree through ``to_jax_params``), so the
    two overlays must agree on every weight."""
    monkeypatch.setenv("I2V_TPU_CKPTS", str(tmp_path))
    init_tree = convert.to_jax_params(
        registry.random_init_(i3d.i3d_tiny(), torch.Generator().manual_seed(4)))

    def jax_builder(num_classes=None, **kw):
        module = ji3d.i3d_tiny(**kw)
        object.__setattr__(module, "init", lambda *_: {"params": init_tree})
        return module

    # the tiny I3D under the full-width name (it keeps its 10-class head)
    monkeypatch.setitem(jvideo_zoo.VIDEO_BUILDERS, "i3d_resnet50", jax_builder)
    monkeypatch.setitem(video_zoo.VIDEO_BUILDERS, "i3d_resnet50",
                        lambda num_classes=None, **kw: i3d.i3d_tiny(**kw))
    tree = convert.to_jax_params(
        registry.random_init_(i3d.i3d_tiny(), torch.Generator().manual_seed(3)))
    dropped = sorted(k for k in tree if k.startswith(("res_layer4", "fc")))
    assert dropped
    jconvert.save_params({k: v for k, v in tree.items() if k not in dropped},
                         "i3d_resnet50_ucf101", str(tmp_path))

    def warned(fn):
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            out = fn()
        return out, [str(w.message) for w in record]

    jbundle, jmsgs = warned(lambda: jvideo_zoo.get_video_model("i3d_resnet50", ucf101=True))
    bundle, msgs = warned(lambda: get_video_model("i3d_resnet50", device="cpu", ucf101=True,
                                                  seed=4))
    assert msgs == jmsgs and len(msgs) == 1
    assert msgs[0].startswith(f"checkpoint for 'i3d_resnet50' left {len(dropped)} module(s)")
    _same_tree(convert.to_jax_params(bundle.module),
               jax.tree_util.tree_map(np.asarray, jbundle.params["params"]))
    assert convert.missing_modules(bundle.module, tree) == []
