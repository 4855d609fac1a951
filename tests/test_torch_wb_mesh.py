"""White-box data parallelism: the port's sign attacks over a clip batch laid
out by ``parallel.mesh.shard_clips`` on ``attack_mesh(data=4)``.

The port's mesh repeats one device, ``[torch.device("cpu")] * 4`` (each
piece is then one clip, attacked on its own); the JAX side lays the batch
over four of the fake CPU devices of ``tests/conftest.py``, as
``tests/test_parallel.py`` ``test_whitebox_dp_sharding_matches_single_device``
does. The same weights (JAX → port through ``from_jax_params``) and the
same numpy clips (four clips of 8 frames at 32², i3d_tiny) go through all
three. Tolerances:
  - the mesh against the port's one-device attack: costs rtol 1e-5 and at
    most 0.1% of the output pixels differing (a sign flips where |g| is
    within the error of 0); the step-0 sign-step direction of each piece
    within 1e-6 of its max against the one-device attack on that piece
    alone (batch-1 convs on both sides), and within 1e-5 of the max against
    the whole batch's (a piece's convs run at batch 1, the whole batch's at
    batch 4: the same sums in other orders, ~1e-7 relative a sum, as
    between two frameworks);
  - the mesh against JAX's sharded attack: costs rtol 1e-5 and at most 0.1%
    of the pixels off by more than JAX's own sharded-vs-single 1e-5, as
    ``tests/test_torch_whitebox.py`` holds the one-device attacks. DI's
    draws are pinned in both packages there (``jax.random`` against a
    ``torch.Generator``), and TAP is held at step 0 by its CE and distance
    (JAX's jitted scan rounds the step-0 perturbation to noise that η = 1e3
    makes its first step, ``tests/test_torch_wb_family.py``).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread  # noqa: E402,F401

import i2v_tpu.attacks as jattacks  # noqa: E402
from i2v_tpu.models import i3d as ji3d  # noqa: E402
from i2v_tpu.models.api import VideoModel as JVideoModel  # noqa: E402
from i2v_tpu.ops import diversity as jdiversity  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu.parallel import mesh as jmesh  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.models import VideoModel, i3d  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402
from i2v_tpu_torch.ops import diversity, kernels, pixel  # noqa: E402
from i2v_tpu_torch.parallel import attack_mesh, shard_clips  # noqa: E402

CLIP = (4, 3, 8, 32, 32)
LABELS = np.asarray([1, 3, 5, 7])
TAPS = ("res_layer1", "res_layer2")
PIECES = 4
COST_RTOL = 1e-5
GRAD_SHARE = 1e-6
GRAD_ATOL = 1e-5
PIXEL_SHARE = 1e-3
JAX_ATOL = 1e-5
CPU4 = [torch.device("cpu")] * PIECES
LOW, HIGH = diversity.default_range(32)
PINNED = (LOW + 2, 1, 2)
TT_PARAMS = dict(kernlen=3, move_type="adj", chunk=3)

# name → the attack, built from a package's attacks module (JAX or port) on a bundle
ATTACKS = {
    "BIM": lambda mod, m: mod.BIM(m, steps=3),
    "MIFGSM": lambda mod, m: mod.MIFGSM(m, steps=4),
    "DIFGSM": lambda mod, m: mod.DIFGSM(m, steps=3, momentum=True),
    "TIFGSM3D": lambda mod, m: mod.TIFGSM3D(m, steps=2, kernlen=5),
    "TAP": lambda mod, m: mod.TAP(m, dict(kernlen=3, temporal_kernlen=3), steps=2),
    "TT": lambda mod, m: mod.TemporalTranslation(m, TT_PARAMS, steps=2),
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


@pytest.fixture
def steps_seen(monkeypatch):
    """Every sign step the engine takes: (device, clips, direction)."""
    seen = []
    plain = kernels.sign_step_project

    def recording(adv01, grad, clean01, alpha, epsilon):
        seen.append((adv01.device, adv01.shape[0], grad.detach().clone()))
        return plain(adv01, grad, clean01, alpha, epsilon)

    monkeypatch.setattr(kernels, "sign_step_project", recording)
    return seen


def _costs(atk, key="cost"):
    return np.asarray([float(atk.loss_info["v"][i][key]) for i in range(len(atk.loss_info["v"]))])


def _unit(g):
    return g / g.abs().max()


@pytest.mark.parametrize("name", sorted(ATTACKS))
def test_mesh_attack_matches_one_device(bundles, videos, steps_seen, name):
    """DI's draws are the engine's own here: every piece sees the step's one
    draw, so the mesh takes the one-device attack's path."""
    _, pb = bundles
    one = ATTACKS[name](attacks, pb)
    want = one(videos, LABELS, ["v"]).numpy()
    assert len(steps_seen) == one.steps and steps_seen[0][1] == CLIP[0]
    step0 = steps_seen[0][2]
    alone = []
    for i in range(PIECES):
        steps_seen.clear()
        ATTACKS[name](attacks, pb)(videos[i:i + 1], LABELS[i:i + 1])
        alone.append(steps_seen[0][2])
    steps_seen.clear()
    laid = ATTACKS[name](attacks, pb)
    got = laid(shard_clips(videos, attack_mesh(CPU4, data=PIECES)), LABELS, ["v"]).numpy()
    # the kernel's step: once a piece a step, on the piece's device, one clip each
    assert len(steps_seen) == laid.steps * PIECES
    assert {(d.type, b) for d, b, _ in steps_seen} == {("cpu", CLIP[0] // PIECES)}
    pieces = [s[2] for s in steps_seen[:PIECES]]
    # each piece's step-0 direction: the piece attacked alone (the same batch-1
    # convs), up to the positive scale the whole batch's mean and L1 norm give
    for i, (g, a) in enumerate(zip(pieces, alone)):
        np.testing.assert_allclose(_unit(g).numpy(), _unit(a).numpy(), rtol=0, atol=GRAD_SHARE,
                                   err_msg=f"piece {i}")
    # and the whole batch's, scale included (batch-4 convs: other sum orders)
    np.testing.assert_allclose(torch.cat(pieces).numpy(), step0.numpy(), rtol=0,
                               atol=GRAD_ATOL * float(step0.abs().max()))
    for key in (("cost", "ce loss", "reg_cost", "distance") if name == "TAP" else ("cost",)):
        np.testing.assert_allclose(_costs(laid, key), _costs(one, key), rtol=COST_RTOL,
                                   err_msg=key)
    assert got.shape == want.shape and np.mean(got != want) <= PIXEL_SHARE


@pytest.fixture
def pinned_di(monkeypatch):
    """Both packages' DI transform replaced by the same pinned draws."""
    rnd, top, left = PINNED
    monkeypatch.setattr(jdiversity, "input_diversity", lambda x, rng, **k:
                        jdiversity.diversity_gather(x, rnd, top, left, LOW, HIGH))
    monkeypatch.setattr(diversity, "input_diversity", lambda x, gen, **k:
                        diversity.diversity_gather(x, rnd, top, left, LOW, HIGH))


@pytest.mark.parametrize("name", sorted(ATTACKS))
def test_mesh_attack_matches_jax_sharded(bundles, videos, pinned_di, name):
    jb, pb = bundles
    jatk, patk = ATTACKS[name](jattacks, jb), ATTACKS[name](attacks, pb)
    jlaid = jmesh.shard_clips(jnp.asarray(videos), jmesh.attack_mesh(jax.devices()[:PIECES],
                                                                      data=PIECES, frames=1))
    jadv = np.asarray(jatk(jlaid, jax.device_put(jnp.asarray(LABELS)), video_names=["v"]))
    padv = patk(shard_clips(videos, attack_mesh(CPU4, data=PIECES)), LABELS, ["v"]).numpy()
    if name == "TAP":
        for key in ("ce loss", "distance"):
            np.testing.assert_allclose(_costs(patk, key)[0], _costs(jatk, key)[0],
                                       rtol=COST_RTOL, err_msg=key)
        return
    np.testing.assert_allclose(_costs(patk), _costs(jatk), rtol=COST_RTOL)
    assert np.mean(np.abs(padv - jadv) > JAX_ATOL) <= PIXEL_SHARE


def test_set_mesh_lays_out_a_whole_batch_and_runs_an_indivisible_one_whole(bundles, videos,
                                                                           steps_seen):
    _, pb = bundles
    mesh = attack_mesh(CPU4, data=PIECES)
    laid = attacks.BIM(pb, steps=2)
    laid.set_mesh(mesh)
    want = attacks.BIM(pb, steps=2)(shard_clips(videos, mesh), LABELS).numpy()
    steps_seen.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(laid(videos, LABELS).numpy(), want)
    assert len(steps_seen) == 2 * PIECES
    steps_seen.clear()
    with pytest.warns(UserWarning, match="batch of 3 does not divide the mesh's 4-way data axis"):
        got = laid(videos[:3], LABELS[:3], ["v"]).numpy()
    assert [b for _, b, _ in steps_seen] == [3, 3]  # whole, on the first device
    one = attacks.BIM(pb, steps=2)
    np.testing.assert_array_equal(got, one(videos[:3], LABELS[:3], ["v"]).numpy())
    np.testing.assert_array_equal(_costs(laid), _costs(one))


def test_replicas_are_built_once_an_attack(bundles, videos):
    """A mesh device other than the model's gets a copy of the model at the
    attack's first call, and the later calls reuse it."""
    _, pb = bundles
    mesh = attack_mesh([torch.device("cpu", 0)] * PIECES, data=PIECES)
    atk = attacks.MIFGSM(pb, steps=1)
    atk(shard_clips(videos, mesh), LABELS)
    replicas = atk._replicas
    replica = replicas.by_device[torch.device("cpu", 0)]
    assert replica is not pb and replica.module is not pb.module
    assert list(replicas.by_device.values()) == [pb, replica]
    atk(shard_clips(videos, mesh), LABELS)
    assert atk._replicas is replicas and list(replicas.by_device.values()) == [pb, replica]


def test_a_frame_sharded_batch_is_refused(bundles, videos):
    from i2v_tpu_torch.parallel.mesh import frame_sharding

    _, pb = bundles
    frames = torch.from_numpy(videos).permute(0, 2, 1, 3, 4).reshape(-1, *CLIP[1:2], *CLIP[3:])
    laid = frame_sharding(attack_mesh(CPU4, data=2)).split(frames)
    with pytest.raises(ValueError, match="'data' axis"):
        attacks.BIM(pb, steps=1)(laid, LABELS)


def test_an_image_guided_attack_does_not_run_over_a_mesh(videos):
    from i2v_tpu_torch.models import get_image_models

    models = get_image_models(["resnet"], {"resnet": 1}, device="cpu", tiny=True, input_hw=32)
    atk = attacks.ImageGuidedFML2_Adam_MultiModels(models, steps=1)
    with pytest.raises(NotImplementedError, match="does not run over a device mesh"):
        atk(shard_clips(videos, attack_mesh(CPU4, data=PIECES)), LABELS)
