"""The port's model-axis ensemble runner (``i2v_tpu_torch.parallel.ensemble``)
against the JAX package's, on ``ensemble_mesh`` of four devices with a model
axis of 2.

The port's mesh repeats one device, ``[torch.device("cpu")] * 4``; the JAX
side runs on four of the fake CPU devices of ``tests/conftest.py``. The
ensemble is tiny ResNet and VGG with two taps each (one a group), their
weights shared through ``from_jax_params``; the clips come from numpy seeds.
Tolerances, as in ``tests/test_torch_mesh.py``: costs against JAX rtol 1e-5
(AENS also atol 1e-5); clips against the port's sequential (mesh-free)
runner within 2e-6 on all but 0.1% of the pixels; the step-0 cost and
gradient at a generic modifier against the sequential ensemble's, rtol 1e-5
and 1e-6 of max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.models import get_image_models as jget_image_models  # noqa: E402
from i2v_tpu.parallel import ensemble as jensemble  # noqa: E402
from i2v_tpu.parallel import multigrid as jmultigrid  # noqa: E402
from i2v_tpu_torch.models import ImageModel, build_image_model, convert  # noqa: E402
from i2v_tpu_torch.ops import pixel  # noqa: E402
from i2v_tpu_torch.parallel import ensemble, multigrid, sharded  # noqa: E402

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


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_clips(got, want):
    assert np.mean(np.abs(_np(got) - _np(want)) > 2e-6) <= 1e-3


def _jmesh():
    return jensemble.ensemble_mesh(jax.devices()[:4], model=2)


def _pmesh():
    return ensemble.ensemble_mesh(CPU4, model=2)


@pytest.mark.parametrize("n", range(1, 9))
def test_ensemble_mesh_matches_jax(n):
    for model in (None, 1, 2, 3, 4):
        try:
            want = jensemble.ensemble_mesh(jax.devices()[:n], model=model)
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                ensemble.ensemble_mesh([torch.device("cpu")] * n, model=model)
            assert str(err.value) == str(e)
            continue
        got = ensemble.ensemble_mesh([torch.device("cpu")] * n, model=model)
        assert got.shape == dict(want.shape)
        assert got.axis_names == want.axis_names == ("model", "frames")


@pytest.mark.parametrize("adaptive,frame_chunk", [(False, None), (True, 4)],
                         ids=["ens", "aens-local-chunk4"])
def test_ensemble_runner_matches_jax(pair, adaptive, frame_chunk):
    """Three steps; AENS twice, the second call starting from the
    coefficients the first left, and each position chunking its own slice."""
    jb, pb = pair
    kw = dict(steps=STEPS, adaptive=adaptive, aens_momentum=0.5, frame_chunk=frame_chunk)
    jrunner = jensemble.make_ensemble_parallel_runner(jb, _jmesh(), **kw)
    runner = ensemble.make_ensemble_parallel_runner(pb, _pmesh(), **kw)
    sequential = sharded.make_sharded_i2v_runner(pb, steps=STEPS, adaptive=adaptive,
                                                 aens_momentum=0.5)
    for seed in ((1, 2) if adaptive else (1,)):
        clean = _clips(seed)
        _, jcosts = jrunner(jnp.asarray(clean))
        adv, costs = runner(torch.from_numpy(clean))
        np.testing.assert_allclose(_np(costs), np.asarray(jcosts), rtol=1e-5,
                                   atol=1e-5 if adaptive else 0)
        want_adv, want_costs = sequential(torch.from_numpy(clean))
        np.testing.assert_allclose(_np(costs), _np(want_costs), rtol=1e-5)
        _close_clips(adv, want_adv)


@pytest.mark.parametrize("adaptive", [False, True], ids=["ens", "aens"])
def test_step0_gradient_is_the_sequential_ensembles(pair, adaptive):
    """The gradient summed over the model axis, each position chunked in
    two, is the sequential ensemble's."""
    pb = pair[1]
    clean = torch.from_numpy(_clips(3))
    mod = torch.from_numpy(((np.random.RandomState(4).rand(2 * T, 3, HW, HW) * 2 - 1)
                            * 0.9 * EPS).astype(np.float32))
    kw = dict(steps=1, adaptive=adaptive, aens_momentum=0.5)
    c0, g0 = sharded.make_sharded_i2v_runner(pb, **kw).value_and_grad(clean, mod)
    c1, g1 = ensemble.make_ensemble_parallel_runner(pb, _pmesh(), frame_chunk=4,
                                                    **kw).value_and_grad(clean, mod)
    assert g1.shape == g0.shape and np.abs(_np(g0)).max() > 0
    np.testing.assert_allclose(float(c1), float(c0), rtol=1e-5)
    assert np.abs(_np(g1) - _np(g0)).max() <= 1e-6 * np.abs(_np(g0)).max()


def test_multigrid_runs_over_the_model_axis_as_jaxs(pair):
    """The coarse-to-fine schedule with the ensemble runner in both phases
    (``runner_factory``): JAX's costs; AENS with multigrid is refused with
    JAX's words."""
    jb, pb = pair
    clean = _clips(5)
    kw = dict(steps=4, coarse_steps=2)
    _, jcosts = jmultigrid.make_multigrid_i2v_runner(
        jb, _jmesh(), runner_factory=jensemble.make_ensemble_parallel_runner,
        **kw)(jnp.asarray(clean))
    adv, costs = multigrid.make_multigrid_i2v_runner(
        pb, _pmesh(), runner_factory=ensemble.make_ensemble_parallel_runner,
        **kw)(torch.from_numpy(clean))
    np.testing.assert_allclose(_np(costs), np.asarray(jcosts), rtol=1e-5)
    a = _np(adv)
    assert a.min() >= 0 and a.max() <= 1 and np.abs(a - clean).max() <= np.float32(EPS) + 1e-6
    with pytest.raises(ValueError) as err:
        ensemble.EnsembleParallelAttack(pb, _pmesh(), steps=4, adaptive=True, multigrid=2)
    with pytest.raises(ValueError) as jerr:
        jensemble.EnsembleParallelAttack(jb, _jmesh(), steps=4, adaptive=True, multigrid=2)
    assert str(err.value) == str(jerr.value)


def test_attack_pads_a_frame_count_the_frames_axis_does_not_divide(pair):
    """One clip of five frames over a frames axis of 2 pads to two clips, as
    JAX's adapter pads it: the pad is inert, the clip and its costs are the
    sequential run's, the costs JAX's."""
    jb, pb = pair
    kw = dict(steps=STEPS, step_size=0.005, adaptive=True, aens_momentum=0.5,
              name="AENS_I2V_MF")
    videos = pixel.normalize(torch.from_numpy(_clips(6, b=1, t=5)), channel_axis=1).numpy()
    atk = ensemble.EnsembleParallelAttack(pb, _pmesh(), **kw)
    jatk = jensemble.EnsembleParallelAttack(jb, _jmesh(), **kw)
    ref = sharded.ShardedImageGuidedAttack(pb, **kw)
    adv = atk(videos, None, ["v"])
    jatk(jnp.asarray(videos), None, ["v"])
    want = ref(videos, None, ["v"])
    assert adv.shape == videos.shape
    _close_clips(pixel.unnormalize(adv, 1), pixel.unnormalize(want, 1))
    costs = [float(atk.loss_info["v"][i]["cost"]) for i in range(STEPS)]
    for info in (ref.loss_info, jatk.loss_info):
        np.testing.assert_allclose(costs, [float(info["v"][i]["cost"]) for i in range(STEPS)],
                                   rtol=1e-5, atol=1e-5)


def test_groups_must_divide_the_model_axis(pair):
    with pytest.raises(ValueError, match="do not split over model axis 4"):
        ensemble.make_ensemble_parallel_runner(pair[1], ensemble.ensemble_mesh(CPU4, model=4),
                                               steps=1)
    with pytest.raises(ValueError, match="frame_chunk must be"):
        ensemble.make_ensemble_parallel_runner(pair[1], _pmesh(), steps=1, frame_chunk="all")
