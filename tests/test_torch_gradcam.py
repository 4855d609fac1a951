"""The port's Grad-CAM (``eval/gradcam.py``, ``cli/gradcam.py``) against the
JAX package's.

Tiny untruncated surrogates share their weights (seeded, crossed as Flax
trees through ``to_jax_params``), the frames come from a seeded numpy
stream, and the JAX functions run jitted. Raw maps and
``tap_offset`` gradients agree to rtol 1e-5 (atol 1e-5·max|·|); normalized
maps to atol 1e-5; ``grad_cam_update``'s second-order gradient to atol
1e-4·max|g|; the CLI's float16 masks to one float16 ulp.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.eval import gradcam as jgradcam  # noqa: E402
from i2v_tpu.models import ImageModel as JImageModel  # noqa: E402
from i2v_tpu.models import registry as jregistry  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu_torch.eval import gradcam  # noqa: E402
from i2v_tpu_torch.models import ImageModel, build_image_model, get_image_models  # noqa: E402
from i2v_tpu_torch.models.convert import to_jax_params  # noqa: E402

HW = 64  # tiny AlexNet's whole forward needs 64²
RTOL = 1e-5
# (name, depth): depth 4 is the CLI's default; a list depth makes SqueezeNet
# tap the Fire concat instead of the expand3x3 ReLU
MODELS = [("resnet", 4), ("vgg", 4), ("alexnet", 4), ("squeezenet", 4),
          ("squeezenet", [2, 3]), ("densenet", 4)]


@pytest.fixture(autouse=True)
def tf32_flags_restored(monkeypatch):
    """The port's CLIs set torch's process-wide TF32 flags
    (``--matmul_precision``); they are put back after each test."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)


def _jax_twin(b, depth):
    module, taps = jregistry.build_image_model(b.name, depth, truncate=False, tiny=True)
    assert taps == b.tap_keys
    return JImageModel(b.name, module, {"params": to_jax_params(b.module)}, taps)


def _twins(name, depth, seed=0):
    """A tiny untruncated port bundle with seeded weights (a normal of std
    1/√fan_in: quicker than the registry's truncated normal on the 4096-wide
    VGG/AlexNet heads) and its JAX twin."""
    module, taps = build_image_model(name, depth, tiny=True, truncate=False, input_hw=HW)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in module.named_parameters():
            if n.endswith("weight") and p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5)
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g) + (n.endswith("scale")))
    b = ImageModel(name, module.eval().requires_grad_(False), taps)
    return b, _jax_twin(b, depth)


def _frames(seed, n=2, hw=HW):
    x = np.random.RandomState(seed).rand(n, hw, hw, 3).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


LABELS = np.array([3, 7])


def _jax_reference(jb, x):
    """What the parity test reads from the JAX package, in one jitted call
    of two traces: ``_cam_raw`` at the argmax class with its ``grad_cam``
    normalization (global min-max, nearest upsample); and at ``LABELS`` the
    ``tap_offset`` gradient at 0 with the map that ``_cam_raw``'s formula
    makes of it."""
    key = jb.tap_keys[0]

    def ref(params, frames):
        cam, _ = jgradcam._cam_raw(dataclasses.replace(jb, params=params), frames, None)

        def score(offset):
            logits, taps = jb.module.apply(params, frames, tap_offset={key: offset})
            labs = jnp.asarray(LABELS)[:, None]
            return jnp.take_along_axis(logits, labs, axis=-1).sum(), taps[key]

        _, acts = jax.eval_shape(lambda f: jb.module.apply(params, f), frames)
        grads, acts = jax.grad(score, has_aux=True)(jnp.zeros(acts[key].shape, jnp.float32))
        lab_cam = jax.nn.relu(jnp.sum(jnp.mean(grads, axis=(1, 2), keepdims=True) * acts, -1))
        return ((cam, jgradcam._upsample(jgradcam._minmax(cam), HW)),
                (lab_cam, jgradcam._upsample(jgradcam._minmax(lab_cam), HW)), grads)

    return jax.jit(ref)(jb.params, jnp.asarray(x))


@pytest.mark.parametrize("name,depth", MODELS,
                         ids=[f"{n}-{'fire' if isinstance(d, list) else d}" for n, d in MODELS])
def test_raw_map_tap_gradient_and_grad_cam_match_jax(name, depth):
    """The ``tap_offset`` gradient at 0 (a CAM's one backward), then
    ``_cam_raw``'s map and ``grad_cam``'s at the argmax class and at given
    labels, against the JAX package's."""
    b, jb = _twins(name, depth)
    x, xt = _frames(1)
    at_argmax, at_labels, jgrad = _jax_reference(jb, x)
    offset = torch.zeros(jgrad.shape[:1] + jgrad.shape[3:] + jgrad.shape[1:3],
                         requires_grad=True)
    logits, _ = b.module(xt, tap_offset={b.tap_keys[0]: offset})
    (g,) = torch.autograd.grad(logits[[0, 1], LABELS].sum(), offset)
    _close(g.numpy().transpose(0, 2, 3, 1), jgrad)
    for labs, (jcam, jmap) in zip((None, LABELS), (at_argmax, at_labels)):
        cam, acts = gradcam._cam_raw(b, xt, labs)
        assert not acts.requires_grad and float(cam.max()) > 0
        _close(cam, jcam)
        _close(gradcam.grad_cam(b, xt, labs, upsample_to=HW), jmap, rtol=1e-4)


@pytest.mark.parametrize("name,depth", [("resnet", 2), ("densenet", 4)])
def test_grad_cam_update_second_order_gradient_matches_jax(name, depth):
    """∂Σ_i‖cam_i(x) − ref_i‖₂/∂x through the map's own gradient: the tap
    offset keeps the path input → tap → logits in the graph."""
    b, jb = _twins(name, depth)
    x, xt = _frames(2)
    ref = np.random.RandomState(3).rand(2, *gradcam.grad_cam(b, xt).shape[1:]).astype(
        np.float32)
    got = gradcam.grad_cam_update(b, xt, torch.from_numpy(ref))
    want = jax.jit(lambda p, f: jgradcam.grad_cam_update(
        dataclasses.replace(jb, params=p), f, jnp.asarray(ref)))(jb.params, jnp.asarray(x))
    assert np.abs(got.numpy()).max() > 0
    _close(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-4)


def test_average_grad_cam_both_modes_and_minmax_per_clip_match_jax():
    """The cross-model mean at a common size, with one global min-max and
    with a min-max per clip; per clip, a clip's mask does not depend on its
    batch-mates."""
    pairs = [_twins(n, d) for n, d in (("resnet", 2), ("densenet", 4))]
    x, xt = _frames(4, n=4)
    x[2:] *= 0.2
    xt[2:] *= 0.2

    def both(params, frames):
        js = [dataclasses.replace(j, params=p) for (_, j), p in zip(pairs, params)]
        return [jgradcam.average_grad_cam(js, frames, upsample_to=HW, frames_per_clip=fpc)
                for fpc in (None, 2)]

    want = jax.jit(both)([j.params for _, j in pairs], jnp.asarray(x))
    for fpc, w in zip((None, 2), want):
        got = gradcam.average_grad_cam([p for p, _ in pairs], xt, upsample_to=HW,
                                       frames_per_clip=fpc)
        _close(got, w, rtol=1e-4)
    alone = gradcam.average_grad_cam([p for p, _ in pairs], xt[:2], upsample_to=HW,
                                     frames_per_clip=2)
    np.testing.assert_allclose(got[:2].numpy(), alone.numpy(), atol=1e-6)
    cam = torch.from_numpy(np.random.RandomState(5).rand(6, 3, 5).astype(np.float32))
    assert np.array_equal(gradcam.minmax_per_clip(cam, 3).numpy(),
                          np.asarray(jgradcam.minmax_per_clip(jnp.asarray(cam.numpy()), 3)))
    assert np.array_equal(gradcam._upsample(cam, 7).numpy(),
                          np.asarray(jgradcam._upsample(jnp.asarray(cam.numpy()), 7)))


def test_visualize_cam_is_byte_equal_to_jax():
    rng = np.random.RandomState(6)
    cam = rng.rand(HW, HW).astype(np.float32)
    frame = rng.rand(HW, HW, 3).astype(np.float32)
    got = gradcam.visualize_cam(torch.from_numpy(cam), frame)
    assert got.dtype == np.uint8 and got.tobytes() == jgradcam.visualize_cam(cam, frame).tobytes()


def test_vit_and_truncated_bundles_are_refused():
    """ViT taps are tokens: the JAX package fails on them with an IndexError,
    the port says why. A truncated bundle has no logits to score."""
    (vit,) = get_image_models(["vit"], 4, device="cpu", tiny=True, truncate=False)
    _, xt = _frames(7, hw=32)
    with pytest.raises(ValueError, match="ViT taps are tokens"):
        gradcam.grad_cam(vit, xt)
    (cut,) = get_image_models(["resnet"], 2, device="cpu", tiny=True, truncate=True)
    with pytest.raises(ValueError, match="built truncated"):
        gradcam.grad_cam(cut, xt)


def _write_clips(run, spec):
    os.makedirs(run, exist_ok=True)
    for label, seed, scale in spec:
        clip01 = (np.random.RandomState(seed).rand(3, 2, HW, HW) * scale).astype(np.float32)
        np.save(os.path.join(run, f"{label}-adv.npy"),
                np.asarray(jpixel.normalize(jnp.asarray(clip01), channel_axis=0)))


def test_cli_masks_match_the_jax_cli_within_one_float16_ulp(tmp_path, monkeypatch):
    """``cli.gradcam`` and the JAX CLI over the same artifacts with the same
    weights (the JAX CLI is handed the port's surrogates): the float16 masks
    agree to one float16 ulp, do not depend on the batch they were computed
    in, and the PNG overlays are written."""
    from i2v_tpu.cli import gradcam as jcli
    from i2v_tpu_torch.cli import gradcam as cli

    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    _write_clips(tmp_path / "run", [(3, 8, 1.0), (5, 9, 0.2)])
    models = ["resnet", "densenet"]
    flags = ["--used_adv", "run", "--tiny", "--models", *models]

    def jax_twins(names, depth, *, tiny, truncate, input_hw):
        return [_jax_twin(b, depth) for b in get_image_models(
            names, depth, device="cpu", tiny=tiny, truncate=truncate, input_hw=input_hw)]

    monkeypatch.setattr(jcli, "get_image_models", jax_twins)
    want = jcli.main(flags + ["--batch_size", "2", "--out", str(tmp_path / "jax")])
    outs = {bs: cli.main(flags + ["--batch_size", str(bs), "--device", "cpu", "--save_png", "1",
                                  "--out", str(tmp_path / f"port{bs}")]) for bs in (1, 2)}
    for label in (3, 5):
        ref = np.load(os.path.join(want, f"{label}-cam.npy"))
        a, b = (np.load(os.path.join(outs[bs], f"{label}-cam.npy")) for bs in (1, 2))
        assert a.shape == (2, HW, HW) and a.dtype == np.float16
        assert np.array_equal(a, b)
        ulp = np.spacing(np.abs(ref).astype(np.float16)).astype(np.float32)
        assert (np.abs(a.astype(np.float32) - ref.astype(np.float32)) <= ulp).all()
        assert np.isclose(float(a.max()), 1, atol=1e-3) and float(a.min()) >= 0
        assert os.path.exists(os.path.join(outs[1], f"{label}-f0.png"))
        assert not os.path.exists(os.path.join(outs[1], f"{label}-f1.png"))


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    from i2v_tpu_torch.cli import gradcam as cli

    _write_clips(tmp_path / "run", [(0, 0, 1.0)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--used_adv", str(tmp_path / "run"), "--tiny"])
    assert cli.arg_parse(["--used_adv", "x"]).models == list(cli.CAM_MODELS)
