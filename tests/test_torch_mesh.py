"""The port's device mesh (``i2v_tpu_torch.parallel.mesh``), its mesh runner
(``make_sharded_i2v_runner(models, mesh)``) and data-parallel evaluation,
against the JAX package's multi-device counterparts.

The port's mesh repeats one device, ``[torch.device("cpu")] * 4``; the JAX
side runs on four of the fake CPU devices that ``tests/conftest.py`` makes.
The same weights (JAX → port through ``from_jax_params``) and the same numpy
clips (2 × 8 frames at 32², tiny ResNet and VGG with two taps each) go
through both. Tolerances, as ``tests/test_torch_sharded.py`` states them:
  - costs, port vs JAX: rtol 1e-5 over three steps (AENS also atol 1e-5:
    its coefficients follow any divergence with a gain);
  - clips, the port's mesh runner vs its mesh-free one: within 2e-6 on all
    but 0.1% of the pixels. The attack starts at the cosine's flat maximum,
    where the step-0 gradient is rounding noise that Adam's g/(|g| + 1e-8)
    turns into whole steps, so clips are held to another framework only
    through the costs;
  - the mesh runner against the mesh-free one at a generic modifier:
    step-0 cost rtol 1e-5, gradient within 1e-6 of max|g|;
  - reports: byte for byte.
"""

import json
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.eval import transfer as jtransfer  # noqa: E402
from i2v_tpu.models import get_image_models as jget_image_models  # noqa: E402
from i2v_tpu.models import video_zoo as jvideo_zoo  # noqa: E402
from i2v_tpu.models.api import VideoModel as JVideoModel  # noqa: E402
from i2v_tpu.parallel import mesh as jmesh  # noqa: E402
from i2v_tpu.parallel import sharded as jsharded  # noqa: E402
from i2v_tpu_torch.data import pipeline  # noqa: E402
from i2v_tpu_torch.eval import transfer  # noqa: E402
from i2v_tpu_torch.models import ImageModel, VideoModel, build_image_model  # noqa: E402
from i2v_tpu_torch.models import convert, video_zoo  # noqa: E402
from i2v_tpu_torch.ops import pixel  # noqa: E402
from i2v_tpu_torch.parallel import mesh, sharded  # noqa: E402

EPS = 16 / 255
HW, T, STEPS = 32, 8, 3
DEPTHS = {"resnet": [1, 2], "vgg": [1, 2]}
CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module")
def pair():
    """Tiny JAX bundles and their port twins, sharing weights."""
    jbundles = jget_image_models(list(DEPTHS), DEPTHS, tiny=True, input_hw=HW)
    ported = []
    for b in jbundles:
        module, taps = build_image_model(b.name, DEPTHS[b.name], tiny=True, input_hw=HW)
        convert.from_jax_params(module, jax.tree_util.tree_map(np.asarray, b.params))
        ported.append(ImageModel(b.name, module.eval().requires_grad_(False), taps))
    return jbundles, ported


def _clips(seed, b=2, t=T):
    return np.random.RandomState(seed).rand(b, 3, t, HW, HW).astype(np.float32)


def _generic_modifier(seed, n):
    return ((np.random.RandomState(seed).rand(n, 3, HW, HW) * 2 - 1) * 0.9 * EPS).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_clips(got, want):
    assert np.mean(np.abs(_np(got) - _np(want)) > 2e-6) <= 1e-3


# -- the mesh and its shardings ------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_attack_mesh_factorization_matches_jax(n):
    for sizes in ({}, {"data": 1}, {"frames": 1}, {"data": 2}, {"frames": 2}):
        jdev = jax.devices()[:n]
        try:
            want = jmesh.attack_mesh(jdev, **sizes)
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                mesh.attack_mesh([torch.device("cpu")] * n, **sizes)
            assert str(err.value) == str(e)
            continue
        got = mesh.attack_mesh([torch.device("cpu")] * n, **sizes)
        assert got.shape == dict(want.shape) and got.size == want.size == n
        assert got.axis_names == want.axis_names == ("data", "frames")


def test_shardings_lay_out_dim0_as_jax_does():
    """Position p of the port's 2×2 mesh holds the rows that JAX's device p
    holds under the same sharding, for the clip, frame and replicated
    shardings; ``gather`` gives back the whole."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    jm = jmesh.attack_mesh(jax.devices()[:4], data=2, frames=2)
    pm = mesh.attack_mesh(CPU4, data=2, frames=2)
    for jsh, psh in ((jmesh.clip_sharding, mesh.clip_sharding),
                     (jmesh.frame_sharding, mesh.frame_sharding),
                     (jmesh.replicated, mesh.replicated)):
        by_device = {s.device: np.asarray(s.data)
                     for s in jax.device_put(x, jsh(jm)).addressable_shards}
        laid = psh(pm).split(torch.from_numpy(x))
        for dev, piece in zip(jm.devices.flat, laid.pieces):
            np.testing.assert_array_equal(piece.numpy(), by_device[dev])
        np.testing.assert_array_equal(mesh.gather(laid).numpy(), x)
    clips = mesh.shard_clips(_clips(0, b=4), pm)
    assert clips.shape == (4, 3, T, HW, HW) and len(clips.distinct_pieces()) == 2
    # a piece held by two positions of one device is one tensor
    assert clips.pieces[0] is clips.pieces[1] and clips.pieces[2] is clips.pieces[3]
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_clips(_clips(0, b=3), pm)
    assert pm == mesh.attack_mesh(CPU4) != mesh.attack_mesh(CPU4, data=1)


def test_no_card_means_no_mesh_and_no_data_parallel_eval(monkeypatch, tmp_path):
    """A multi-device entry point without a card raises; it never takes the
    CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.attack_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transfer.evaluate_run(str(tmp_path), data_parallel=True, device="cuda")


def test_replicate_copies_onto_another_device_only(pair):
    pb = pair[1]
    assert all(a is b for a, b in zip(sharded.replicate(pb, "cpu"), pb))
    meta = sharded.replicate(pb, "meta")
    assert all(p.device.type == "meta" for m in meta for p in m.module.parameters())
    assert all(p.device.type == "cpu" for m in pb for p in m.module.parameters())
    assert [m.tap_keys for m in meta] == [m.tap_keys for m in pb]


# -- the mesh runner against JAX's ---------------------------------------------------

@pytest.mark.parametrize("adaptive", [False, True], ids=["ens", "aens"])
def test_mesh_runner_matches_jax_on_four_devices(pair, adaptive):
    """Three steps over attack_mesh of four devices (data 2 × frames 2), and
    for AENS a second call that starts from the coefficients the first left."""
    jb, pb = pair
    kw = dict(steps=STEPS, adaptive=adaptive, aens_momentum=0.5)
    jrunner = jsharded.make_sharded_i2v_runner(jb, jmesh.attack_mesh(jax.devices()[:4]), **kw)
    runner = sharded.make_sharded_i2v_runner(pb, mesh.attack_mesh(CPU4), **kw)
    alone = sharded.make_sharded_i2v_runner(pb, **kw)
    for seed in ((1, 2) if adaptive else (1,)):
        clean = _clips(seed)
        _, jcosts = jrunner(jnp.asarray(clean))
        adv, costs = runner(torch.from_numpy(clean))
        np.testing.assert_allclose(_np(costs), np.asarray(jcosts), rtol=1e-5,
                                   atol=1e-5 if adaptive else 0)
        want_adv, want_costs = alone(torch.from_numpy(clean))
        np.testing.assert_allclose(_np(costs), _np(want_costs), rtol=1e-5)
        _close_clips(adv, want_adv)
        assert _np(costs)[-1] < _np(costs)[0]


@pytest.mark.parametrize("adaptive", [False, True], ids=["ens", "aens"])
def test_mesh_step0_gradient_is_the_mesh_free_runners(pair, adaptive):
    """Cut over four positions (data 2 × frames 2, each chunked in two) or
    whole: the same step-0 cost and gradient at a generic modifier."""
    pb = pair[1]
    clean = torch.from_numpy(_clips(3))
    mod = torch.from_numpy(_generic_modifier(4, 2 * T))
    kw = dict(steps=1, adaptive=adaptive, aens_momentum=0.5)
    c0, g0 = sharded.make_sharded_i2v_runner(pb, **kw).value_and_grad(clean, mod)
    c1, g1 = sharded.make_sharded_i2v_runner(pb, mesh.attack_mesh(CPU4, data=2), frame_chunk=8,
                                             **kw).value_and_grad(clean, mod)
    assert g1.shape == g0.shape and np.abs(_np(g0)).max() > 0
    np.testing.assert_allclose(float(c1), float(c0), rtol=1e-5)
    assert np.abs(_np(g1) - _np(g0)).max() <= 1e-6 * np.abs(_np(g0)).max()


def test_laid_out_clips_and_chained_segments_on_the_mesh(pair):
    """Clips handed over as the mesh's clip-sharding pieces give the whole
    batch's run bit for bit; two resumable 2-step segments on the mesh (the
    modifier and Adam's moments gathered in frame order and cut again) are
    one 4-step run bit for bit."""
    pb = pair[1]
    pm = mesh.attack_mesh(CPU4, data=2, frames=2)
    clean = torch.from_numpy(_clips(5))
    kw = dict(return_modifier=True, opt_state_io=True)
    whole = sharded.make_sharded_i2v_runner(pb, pm, steps=4, **kw)(clean)
    laid = sharded.make_sharded_i2v_runner(pb, pm, steps=4, **kw)(mesh.shard_clips(clean, pm))
    seg = sharded.make_sharded_i2v_runner(pb, pm, steps=2, **kw)
    first = seg(clean)
    second = seg(clean, mod_init=first[2], opt_init=first[3])
    assert whole[2].shape == (2 * T, 3, HW, HW) and float(whole[3][0]) == 4
    np.testing.assert_array_equal(np.concatenate([_np(first[1]), _np(second[1])]),
                                  _np(whole[1]))
    for got in (laid, second):
        for a, b in [(got[0], whole[0]), (got[2], whole[2])] + list(zip(got[3], whole[3])):
            np.testing.assert_array_equal(_np(a), _np(b))


def test_auto_chunk_scales_with_the_mesh(pair, monkeypatch):
    """``n_devices`` multiplies the per-device budget (JAX
    ``resolve_frame_chunk``); on a mesh the batch's chunk is cut over the
    positions, so "auto" there is the explicit chunk of the same size."""
    budget = 4 * 224 * 224 * 256
    assert sharded.resolve_frame_chunk("auto", 2048, (224, 224), n_devices=4) == 1024
    assert sharded.resolve_frame_chunk("auto", 1024, (224, 224), n_devices=4) is None
    assert sharded.resolve_frame_chunk(64, 2048, (224, 224), n_devices=4) == 64
    assert sharded.AUTO_CHUNK_BYTES == budget
    monkeypatch.setattr(sharded, "AUTO_CHUNK_BYTES", 4 * HW * HW * 2)   # 2 frames a device
    pm = mesh.attack_mesh(CPU4)
    assert sharded._local_chunk("auto", 2 * T, (HW, HW), torch.float32, 4) == 2
    assert sharded._local_chunk(None, 2 * T, (HW, HW), torch.float32, 4) == 4
    clean = torch.from_numpy(_clips(6))
    auto = sharded.make_sharded_i2v_runner(pair[1], pm, steps=2, frame_chunk="auto")(clean)
    expl = sharded.make_sharded_i2v_runner(pair[1], pm, steps=2, frame_chunk=8)(clean)
    for a, b in zip(auto, expl):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_padded_trailing_batch_is_inert_on_the_mesh(pair):
    """Three clips over data 2 × frames 2 pad to four (a repeat of the third),
    as JAX's adapter pads them: the real clips are the mesh-free 3-clip
    run's, and the recorded costs are that run's and JAX's, as are AENS's
    coefficients for the next batch."""
    jb, pb = pair
    kw = dict(steps=STEPS, step_size=0.005, adaptive=True, aens_momentum=0.5, name="AENS_I2V_MF")
    pm = mesh.attack_mesh(CPU4, data=2, frames=2)
    atk = sharded.ShardedImageGuidedAttack(pb, pm, **kw)
    ref = sharded.ShardedImageGuidedAttack(pb, **kw)
    jatk = jsharded.ShardedImageGuidedAttack(
        jb, jmesh.attack_mesh(jax.devices()[:4], data=2, frames=2), **kw)
    for seed, b in ((7, 3), (8, 4)):
        videos = pixel.normalize(torch.from_numpy(_clips(seed, b=b)), channel_axis=1).numpy()
        names = [f"v{i}" for i in range(b)]
        adv = atk(videos, None, names)
        want = ref(videos, None, names)
        jatk(jnp.asarray(videos), None, names)
        assert adv.shape == videos.shape
        _close_clips(pixel.unnormalize(adv, 1), pixel.unnormalize(want, 1))
        for info in (ref.loss_info, jatk.loss_info):
            np.testing.assert_allclose(
                [float(atk.loss_info["v0"][i]["cost"]) for i in range(STEPS)],
                [float(info["v0"][i]["cost"]) for i in range(STEPS)], rtol=1e-5, atol=1e-5)


def test_pipeline_lands_batches_as_the_mesh_pieces():
    """Over a mesh, a batch that divides lands as its clip-sharding pieces;
    a trailing one that does not lands whole on the first device."""
    pm = mesh.attack_mesh(CPU4, data=2, frames=2)
    clips = _clips(9, b=3)
    batches = [{"clips": clips[:2], "labels": [0, 1]}, {"clips": clips[2:], "labels": [2]}]
    out = list(pipeline.device_prefetch(iter(batches), "cpu", mesh=pm))
    assert isinstance(out[0]["clips"], mesh.Sharded)
    np.testing.assert_array_equal(out[0]["clips"].gather().numpy(), clips[:2])
    assert isinstance(out[1]["clips"], torch.Tensor)
    np.testing.assert_array_equal(out[1]["clips"].numpy(), clips[2:])


# -- data-parallel evaluation ----------------------------------------------------------

EVAL_MODEL = "slowfast_resnet50"
LABELS = (0, 2, 3, 5, 9)   # batch_size 4 over four positions: one batch cut, one whole
CSV, JSON = "results_all_models_prediction.csv", "top1_acc_all_models.json"


@pytest.fixture(scope="module")
def video_pair():
    jmod = jvideo_zoo.TINY_BUILDERS[EVAL_MODEL]()
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 3, 8, 32, 32))))
    pmod = convert.from_jax_params(video_zoo.TINY_BUILDERS[EVAL_MODEL](), params).eval()
    return (JVideoModel(EVAL_MODEL, jmod, jax.device_put(params)),
            VideoModel(EVAL_MODEL, pmod.requires_grad_(False)))


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_run")
    rng = np.random.RandomState(10)
    for label in LABELS:
        np.save(d / f"{label}-adv.npy", rng.randn(3, 8, 32, 32).astype(np.float32))
    return d


def _reports(run_dir):
    with open(os.path.join(run_dir, CSV), "rb") as f, open(os.path.join(run_dir, JSON)) as g:
        return f.read(), json.load(g)


def test_data_parallel_reports_are_the_serial_ones_and_jaxs(video_pair, eval_dir, tmp_path):
    """Serial and single-pass evaluation over the four-position mesh write
    the mesh-free run's reports byte for byte, and JAX's data-parallel
    evaluation over four devices writes the same CSV. The trailing batch of
    one clip does not divide over the mesh: it runs whole, with a warning."""
    runs = {k: shutil.copytree(eval_dir, tmp_path / k)
            for k in ("serial", "dp", "dp_single", "jax")}
    kw = dict(model_names=[EVAL_MODEL], batch_size=4, n_classes=10, device="cpu",
              get_bundle=lambda n: video_pair[1], log=lambda *_: None)
    pm = mesh.attack_mesh(CPU4)
    want = transfer.evaluate_run(str(runs["serial"]), **kw)
    for key, single in (("dp", False), ("dp_single", True)):
        with pytest.warns(UserWarning, match="does not divide the 4-position mesh"):
            got = transfer.evaluate_run(str(runs[key]), mesh=pm, single_pass=single, **kw)
        assert got == want
        assert _reports(runs[key]) == _reports(runs["serial"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jwant = jtransfer.evaluate_run(str(runs["jax"]), model_names=[EVAL_MODEL], batch_size=4,
                                       n_classes=10, get_bundle=lambda n: video_pair[0],
                                       mesh=jmesh.attack_mesh(jax.devices()[:4]),
                                       log=lambda *_: None)
    jcsv, jjson = _reports(runs["jax"])
    assert jcsv == _reports(runs["serial"])[0]
    assert abs(jjson[EVAL_MODEL] - want[EVAL_MODEL]) <= 1e-6
    assert abs(jwant[EVAL_MODEL] - want[EVAL_MODEL]) <= 1e-6
