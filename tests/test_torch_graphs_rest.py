"""The port's last eager loops as capture-ready steps: DIFGSM and
TemporalTranslation with their draws in device tables, the model-axis
ensemble runner, and the Grad-CAM evaluator.

On the CPU the capture-ready steps run eagerly, so each is held here, bit
for bit, to the eager form the port ran before:
  - DI's table gather against ``diversity_gather`` at the host draws (values
    and gradient over 20 steps, kept rows among them), and the table
    against the per-step draws of the same generator;
  - DIFGSM (± momentum, ± ``batch_chunk``, one piece and two) and
    TemporalTranslation ('adj', 'large', 'random'; 'random' over two pieces
    too) against the old loop, restated below (``_ref_drawn``): every piece,
    and every clip-batch chunk, restarted from the step's generator state
    and drew the step's values on the host;
  - the model-axis runner (ENS and AENS on a (2, 2) CPU mesh) against the
    old loop with ``torch.optim.Adam(foreach=False)`` (``_ref_ensemble``);
  - the Grad-CAM evaluator against ``_cam_raw``;
  - a second batch of one layout reuses the first's loop and gives what a
    fresh engine gives.
Against the JAX package, at the tolerances of the existing tests: the DI
gather bit for bit (tests/test_torch_wb_family.py), the device-shift move
bit for bit, TT 'adj' costs rtol 1e-5 and output pixels differing at most
0.1% (tests/test_torch_temporal.py), the ensemble's costs rtol 1e-5, AENS
also atol 1e-5 (tests/test_torch_ensemble.py), the raw CAM rtol 1e-5 with
atol 1e-5·max (tests/test_torch_gradcam.py). ``tests/test_torch_graphs.py``
holds every new step kind under its no-host-read dispatch mode;
``tests/test_torch_graphs_card.py`` their capture and replay on a card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

import i2v_tpu.attacks as jattacks  # noqa: E402
from i2v_tpu.eval import gradcam as jgradcam  # noqa: E402
from i2v_tpu.models import get_image_models as jget_image_models  # noqa: E402
from i2v_tpu.models import i3d as ji3d  # noqa: E402
from i2v_tpu.models.api import ImageModel as JImageModel  # noqa: E402
from i2v_tpu.models.api import VideoModel as JVideoModel  # noqa: E402
from i2v_tpu.models import registry as jregistry  # noqa: E402
from i2v_tpu.ops import diversity as jdiversity  # noqa: E402
from i2v_tpu.ops import smoothing as jsmoothing  # noqa: E402
from i2v_tpu.parallel import ensemble as jensemble  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.attacks import core  # noqa: E402
from i2v_tpu_torch.attacks.i2v import MODIFIER_INIT  # noqa: E402
from i2v_tpu_torch.cli import gradcam as gradcam_cli  # noqa: E402
from i2v_tpu_torch.eval import gradcam  # noqa: E402
from i2v_tpu_torch.models import (ImageModel, VideoModel, build_image_model, convert,  # noqa: E402
                                  get_video_model, i3d)
from i2v_tpu_torch.ops import diversity, kernels, pixel, smoothing  # noqa: E402
from i2v_tpu_torch.parallel import ensemble, sharded  # noqa: E402
from i2v_tpu_torch.utils import graphs  # noqa: E402

EPS = 16 / 255
HW, T, STEPS = 32, 8, 3
CPU = torch.device("cpu")
LOW, HIGH = diversity.default_range(HW)
ENS_DEPTHS = {"resnet": [1, 2], "vgg": [1, 2]}


def _clips01(seed, b=2, t=T, hw=HW):
    return torch.from_numpy(np.random.RandomState(seed).rand(b, 3, t, hw, hw).astype(np.float32))


def _equal(a, b):
    a, b = (x.detach() if isinstance(x, torch.Tensor) else x for x in (a, b))
    assert torch.equal(a, b), float((a - b).abs().max())


@pytest.fixture(scope="module")
def video():
    return get_video_model("i3d_resnet50", device="cpu", tiny=True)


@pytest.fixture(scope="module")
def ens_pair():
    """Tiny JAX ResNet and VGG with two taps each and their port twins."""
    jbundles = jget_image_models(list(ENS_DEPTHS), ENS_DEPTHS, tiny=True, input_hw=HW)
    ported = []
    for b in jbundles:
        module, taps = build_image_model(b.name, ENS_DEPTHS[b.name], tiny=True, input_hw=HW)
        convert.from_jax_params(module, jax.tree_util.tree_map(np.asarray, b.params))
        ported.append(ImageModel(b.name, module.eval().requires_grad_(False), taps))
    return jbundles, ported


# -- the eager loops the port ran before ---------------------------------------------------

def _ref_chunked(fn, b, chunk):
    """core._chunked as it was: every chunk restarts from the step's
    generator state."""
    if not chunk or chunk >= b:
        return fn
    if b % chunk:
        chunk = max(d for d in range(1, chunk + 1) if b % d == 0)
    k = b // chunk

    def chunked(adv, labels, generator):
        state = generator.get_state()
        costs, grads = [], []
        for i in range(k):
            generator.set_state(state)
            c, g = fn(adv[i * chunk:(i + 1) * chunk], labels[i * chunk:(i + 1) * chunk],
                      generator)
            costs.append(c)
            grads.append(g)
        return torch.stack(costs).mean(0), torch.cat(grads) / k

    return chunked


def _ref_drawn(grad_fns, clean, labels, cfg, generator):
    """run_sign_attack_pieces' old eager loop with host draws: every piece
    restarted from the step's generator state, each grad_fn drew the step's
    values from it."""
    n = len(clean)
    fns = [_ref_chunked(fn, c.shape[0], cfg.batch_chunk) for fn, c in zip(grad_fns, clean)]
    adv = list(clean)
    mom = [torch.zeros_like(c) for c in clean] if cfg.use_momentum else None
    costs = []
    for _ in range(cfg.steps):
        state = generator.get_state()
        step_costs, gs = [], []
        for fn, a, lab in zip(fns, adv, labels):
            if n > 1:
                generator.set_state(state)
            cost, g = fn(a, lab, generator)
            step_costs.append(cost.detach())
            gs.append(g / n if n > 1 else g)
        if cfg.grad_norm == "l1" and n > 1:
            total = torch.stack([torch.sum(torch.abs(g)) for g in gs]).sum()
            gs = [core.grad_ops.l1_normalize(g, total) for g in gs]
        else:
            gs = [core._apply_grad_norm(g, cfg.grad_norm) for g in gs]
        for i, g in enumerate(gs):
            if cfg.use_momentum:
                g = g + mom[i] * cfg.decay
                mom[i] = g
            adv[i] = kernels.sign_step_project(adv[i], g, clean[i], cfg.alpha, cfg.epsilon)
        costs.append(step_costs[0] if n == 1 else torch.stack(step_costs).mean(0))
    return adv, torch.stack(costs)


def _tt_cfg(atk):
    return core.SignAttackConfig(epsilon=atk.epsilon, steps=atk.steps, step_size=atk.step_size,
                                 use_momentum=atk.momentum, decay=atk.delay,
                                 grad_norm="frame" if atk.momentum else None)


def _ref_ensemble(models, clean, *, m_size, cols, steps, adaptive=False, momentum=0.0,
                  frame_chunk=None, coeffs0=None, mod_init=None):
    """The model-axis runner's old loop: position (g, f) through group g's
    models over slice f, the gradients summed over g, torch.optim.Adam over
    the slices' leaf modifiers, the cost summed in position order."""
    per = len(models) // m_size
    groups = [models[g * per:(g + 1) * per] for g in range(m_size)]
    counts = [sum(len(m.tap_keys) for m in grp) for grp in groups]
    taps = [slice(sum(counts[:g]), sum(counts[:g + 1])) for g in range(m_size)]
    n_taps = sum(counts)
    b = clean.shape[0]
    slices = sharded._slices(pixel.flatten_clip_to_frames(clean), cols)
    n_local = slices[0].shape[0]
    chunk = sharded.snap_frame_chunk(sharded.resolve_frame_chunk(
        frame_chunk, n_local, slices[0].shape[2:]), n_local)
    positions = [[sharded._position(groups[g], slices[f], chunk, None, taps[g])
                  for f in range(cols)] for g in range(m_size)]
    grad_of = functools.partial(sharded._position_grad, epsilon=EPS, adaptive=adaptive,
                                coef_ce=False, n_taps=n_taps, remat=False)
    inits = None if mod_init is None else sharded._slices(mod_init, cols)
    mods = [(torch.full_like(s, MODIFIER_INIT) if inits is None else inits[f].clone())
            .requires_grad_(True) for f, s in enumerate(slices)]
    opt = torch.optim.Adam(mods, lr=0.005, betas=(0.9, 0.999), eps=1e-8, foreach=False,
                           fused=False)
    coeffs_prev = torch.ones(n_taps) if coeffs0 is None else coeffs0
    prev = torch.ones(n_taps)
    costs = []
    for _ in range(steps):
        coeffs = (torch.softmax(torch.softmax(prev, 0) + momentum * coeffs_prev, 0)
                  if adaptive else None)
        cost, grads, signals = None, [None] * cols, [None] * m_size
        for g in range(m_size):
            for f in range(cols):
                c, s, gr = grad_of(positions[g][f], mods[f], coeffs)
                cost = c if cost is None else cost + c
                grads[f] = gr if grads[f] is None else grads[f] + gr
                signals[g] = s if signals[g] is None else signals[g] + s
        for m, gr in zip(mods, grads):
            m.grad = gr
        opt.step()
        costs.append(cost)
        if adaptive:
            coeffs_prev, prev = coeffs, torch.cat(signals)
    adv = torch.cat([kernels.rebuild_adv(s, m.detach(), EPS) for s, m in zip(slices, mods)])
    return (pixel.unflatten_frames_to_clip(adv, b), torch.stack(costs), coeffs_prev,
            torch.cat([m.detach() for m in mods]))


# -- DI's draw table -------------------------------------------------------------------------

def test_draw_table_is_the_per_step_draws_of_the_same_generator():
    rows = diversity.draw_table(torch.Generator().manual_seed(5), 40, LOW, HIGH)
    gen = torch.Generator().manual_seed(5)
    want = [diversity.draw(gen, LOW, HIGH) for _ in range(40)]
    assert rows.shape == (40, 4) and rows.dtype == np.int64
    assert [tuple(r) for r in rows.tolist()] == [(int(a), r, t, c) for a, r, t, c in want]
    assert 0 < rows[:, 0].sum() < 40


def test_table_gather_is_the_host_gather_values_and_gradient_over_20_steps():
    """Each row's gather equals ``input_diversity`` at the same draws (the
    JAX package's ``diversity_gather`` where the row applies), values and
    gradient bit for bit; a kept row is the input and passes the gradient
    through."""
    rows = diversity.draw_table(torch.Generator().manual_seed(9), 20, LOW, HIGH)
    assert {0, 1} <= set(rows[:, 0].tolist())
    table = graphs.DrawTable(rows, CPU)
    gen = torch.Generator().manual_seed(9)
    rng = np.random.RandomState(0)
    for step in range(20):
        x = torch.from_numpy(rng.randn(2, 3, 2, LOW, LOW).astype(np.float32))
        w = torch.from_numpy(rng.randn(2, 3, 2, LOW, LOW).astype(np.float32))
        got_x, want_x = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
        got = diversity.input_diversity(got_x, table.row())
        want = diversity.input_diversity(want_x, gen)
        _equal(got, want)
        apply, rnd, top, left = rows[step].tolist()
        if apply:
            np.testing.assert_array_equal(got.detach().numpy(), np.asarray(
                jdiversity.diversity_gather(jnp.asarray(x.numpy()), rnd, top, left, LOW, HIGH)))
        else:
            _equal(got, x)
        (g_got,) = torch.autograd.grad((got * w).sum(), got_x)
        (g_want,) = torch.autograd.grad((want * w).sum(), want_x)
        _equal(g_got, g_want)
    assert int(table.k) == 20


def test_device_shift_move_is_torch_roll_and_jaxs():
    clip = torch.from_numpy(np.random.RandomState(1).randn(2, 3, T, 4, 4).astype(np.float32))
    for shift in range(-2 * T - 1, 2 * T + 2):
        got = smoothing.cycle_move_at(clip, torch.tensor(shift))
        _equal(got, torch.roll(clip, shift, dims=2))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jsmoothing.cycle_move(jnp.asarray(clip.numpy()), shift)))


# -- DIFGSM -------------------------------------------------------------------------------------

DIFGSM_CASES = {
    "plain": dict(momentum=False, chunk=None, pieces=1),
    "momentum": dict(momentum=True, chunk=None, pieces=1),
    "chunked": dict(momentum=False, chunk=1, pieces=1),
    "momentum-chunked": dict(momentum=True, chunk=1, pieces=1),
    "two-pieces": dict(momentum=False, chunk=None, pieces=2),
    "momentum-two-pieces": dict(momentum=True, chunk=None, pieces=2),
}


def _difgsm(video, case, steps=4):
    atk = attacks.DIFGSM(video, steps=steps, momentum=case["momentum"])
    if case["chunk"]:
        atk.cfg = dataclasses.replace(atk.cfg, batch_chunk=case["chunk"])
    return atk


def _pieces(clean, labels, n):
    per = clean.shape[0] // n
    return ([clean[i * per:(i + 1) * per] for i in range(n)],
            [labels[i * per:(i + 1) * per] for i in range(n)])


@pytest.mark.parametrize("name", sorted(DIFGSM_CASES))
def test_difgsm_equals_the_eager_loop_at_the_same_seed(video, name):
    case = DIFGSM_CASES[name]
    clean, labels = _pieces(_clips01(1), torch.tensor([1, 3]), case["pieces"])
    atk = _difgsm(video, case)
    adv, costs = atk._attack_pieces(clean, labels, [CPU] * len(clean))
    ref = _difgsm(video, case)
    r_adv, r_costs = _ref_drawn([ref._build_grad_fn(video) for _ in clean], clean, labels,
                                ref.cfg, torch.Generator().manual_seed(0))
    _equal(costs, r_costs)
    for got, want in zip(adv, r_adv):
        _equal(got, want)
    # the table the loop read: the call's generator's draws, one row a step
    loop = next(iter(atk._loops.values()))
    want_rows = diversity.draw_table(torch.Generator().manual_seed(0), 4, LOW, HIGH)
    for table in loop.tables:
        np.testing.assert_array_equal(table.table.numpy(), want_rows)


def test_difgsm_second_batch_reuses_its_loop(video):
    atk = attacks.DIFGSM(video, steps=STEPS)
    atk._attack_pieces([_clips01(2)], [torch.tensor([0, 1])], [CPU])
    adv, costs = atk._attack_pieces([_clips01(3)], [torch.tensor([2, 3])], [CPU])
    assert len(atk._loops) == 1
    fresh = attacks.DIFGSM(video, steps=STEPS)
    fresh._calls = 1   # the second call's draws
    f_adv, f_costs = fresh._attack_pieces([_clips01(3)], [torch.tensor([2, 3])], [CPU])
    _equal(costs, f_costs)
    _equal(adv[0], f_adv[0])


# -- TemporalTranslation -----------------------------------------------------------------------

TT_CASES = {
    "adj": dict(move_type="adj", momentum=False, weight=0.0, chunk=3, pieces=1),
    "adj-momentum": dict(move_type="adj", momentum=True, weight=0.5, chunk=1, pieces=1),
    "large": dict(move_type="large", momentum=False, weight=0.5, chunk=3, pieces=1),
    "random": dict(move_type="random", momentum=True, weight=0.5, chunk=3, pieces=1),
    "random-two-pieces": dict(move_type="random", momentum=False, weight=0.5, chunk=1,
                              pieces=2),
}


def _tt(model, case, steps=STEPS, graphs=True):
    params = dict(kernlen=3, momentum=case["momentum"], weight=case["weight"],
                  move_type=case["move_type"], kernel_mode="gaussian", chunk=case["chunk"])
    return attacks.TemporalTranslation(model, params, steps=steps, graphs=graphs)


@pytest.mark.parametrize("name", sorted(TT_CASES))
def test_tt_equals_the_eager_loop_at_the_same_seed(video, name):
    case = TT_CASES[name]
    clean, labels = _pieces(_clips01(4), torch.tensor([2, 5]), case["pieces"])
    atk = _tt(video, case)
    adv, costs = atk._attack_pieces(clean, labels, [CPU] * len(clean))
    ref = _tt(video, case)
    r_adv, r_costs = _ref_drawn([ref._build_grad_fn(video) for _ in clean], clean, labels,
                                _tt_cfg(ref), torch.Generator().manual_seed(0))
    _equal(costs, r_costs)
    for got, want in zip(adv, r_adv):
        _equal(got, want)
    loop = next(iter(atk._loops.values()))
    if case["move_type"] != "random":
        assert loop.tables == []
        return
    gen = torch.Generator().manual_seed(0)
    want_rows = np.asarray([ref._shifts(T, gen) for _ in range(STEPS)])
    assert np.abs(want_rows).sum() > 0
    for table in loop.tables:
        np.testing.assert_array_equal(table.table.numpy(), want_rows)


def test_tt_second_batch_reuses_its_loop(video):
    case = TT_CASES["random"]
    atk = _tt(video, case)
    atk._attack_pieces([_clips01(5)], [torch.tensor([0, 1])], [CPU])
    adv, costs = atk._attack_pieces([_clips01(6)], [torch.tensor([2, 3])], [CPU])
    assert len(atk._loops) == 1
    fresh = _tt(video, case)
    fresh._calls = 1
    f_adv, f_costs = fresh._attack_pieces([_clips01(6)], [torch.tensor([2, 3])], [CPU])
    _equal(costs, f_costs)
    _equal(adv[0], f_adv[0])


def test_tt_adj_second_batch_matches_jax():
    """Two batches through the cached loop against JAX's TT: the step-0 cost
    and one step (costs rtol 1e-5, output pixels differing at most 0.1%, as
    test_torch_temporal.py). One step, as that file holds 'large': at these
    clips the trajectory is chaotic (the first batch's step parts 0.06% of
    the pixels, and after three steps 6% differ, the port's eager loop the
    same)."""
    clip = (2, 3, T, HW, HW)
    jmod = ji3d.i3d_tiny()
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.zeros((1,) + clip[1:]))
    jb = JVideoModel("i3d_resnet50", jmod, params, ())
    module = convert.from_jax_params(i3d.i3d_tiny(), jax.tree_util.tree_map(np.asarray, params))
    pb = VideoModel("i3d_resnet50", module.eval().requires_grad_(False), ())
    tt = dict(kernlen=3, momentum=True, weight=0.5, move_type="adj", kernel_mode="gaussian",
              chunk=3)
    jatk = jattacks.TemporalTranslation(jb, tt, steps=1)
    atk = attacks.TemporalTranslation(pb, tt, steps=1)
    labels = np.asarray([2, 5])
    for seed in (7, 8):
        videos = np.asarray(pixel.normalize(_clips01(seed), channel_axis=1))
        jatk.loss_info, atk.loss_info = {}, {}
        jadv = np.asarray(jatk(jnp.asarray(videos), jnp.asarray(labels), video_names=["v"]))
        padv = atk(videos, labels, ["v"]).numpy()
        np.testing.assert_allclose(float(atk.loss_info["v"][0]["cost"]),
                                   float(jatk.loss_info["v"][0]["cost"]), rtol=1e-5)
        assert np.mean(padv != jadv) <= 1e-3
    assert len(atk._loops) == 1


# -- the model-axis runner ---------------------------------------------------------------------

def _pmesh():
    return ensemble.ensemble_mesh([CPU] * 4, model=2)


@pytest.mark.parametrize("adaptive,chunk", [(False, None), (True, None), (True, 4)],
                         ids=["ens", "aens", "aens-chunk4"])
def test_ensemble_runner_equals_the_eager_loop(ens_pair, adaptive, chunk):
    """Two calls: AENS's second starts from the coefficients the first left."""
    pb = ens_pair[1]
    runner = ensemble.make_ensemble_parallel_runner(pb, _pmesh(), steps=STEPS, adaptive=adaptive,
                                                    aens_momentum=0.5, frame_chunk=chunk)
    coeffs = None
    for seed in (10, 11):
        clean = _clips01(seed)
        adv, costs = runner(clean)
        r_adv, r_costs, coeffs, _ = _ref_ensemble(pb, clean, m_size=2, cols=2, steps=STEPS,
                                                  adaptive=adaptive, momentum=0.5,
                                                  frame_chunk=chunk, coeffs0=coeffs)
        _equal(costs, r_costs)
        _equal(adv, r_adv)
        if adaptive:
            _equal(runner.coefficients(), coeffs)
    assert len(runner.loops) == 1


@pytest.mark.parametrize("adaptive", [False, True], ids=["ens", "aens"])
def test_ensemble_runner_second_batch_matches_jax(ens_pair, adaptive):
    jb, pb = ens_pair
    kw = dict(steps=STEPS, adaptive=adaptive, aens_momentum=0.5)
    jrunner = jensemble.make_ensemble_parallel_runner(
        jb, jensemble.ensemble_mesh(jax.devices()[:4], model=2), **kw)
    runner = ensemble.make_ensemble_parallel_runner(pb, _pmesh(), **kw)
    for seed in (12, 13):
        clean = _clips01(seed)
        _, jcosts = jrunner(jnp.asarray(clean.numpy()))
        _, costs = runner(clean)
        np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-5,
                                   atol=1e-5 if adaptive else 0)
    assert len(runner.loops) == 1


def test_ensemble_second_batch_equals_a_fresh_runner(ens_pair):
    pb = ens_pair[1]
    kw = dict(steps=STEPS, frame_chunk=4)
    runner = ensemble.make_ensemble_parallel_runner(pb, _pmesh(), **kw)
    runner(_clips01(14))
    adv, costs = runner(_clips01(15))
    f_adv, f_costs = ensemble.make_ensemble_parallel_runner(pb, _pmesh(), **kw)(_clips01(15))
    _equal(costs, f_costs)
    _equal(adv, f_adv)
    runner(_clips01(16, b=1))     # another shape, another loop
    assert len(runner.loops) == 2


def test_ensemble_resumes_from_mod_init_as_the_eager_loop(ens_pair):
    """``mod_init`` (the multigrid handoff) and ``return_modifier``: the
    modifier the old loop started from and ended with, on a (4, 1) mesh,
    where each slice's gradient is summed over four positions."""
    pb = ens_pair[1] * 2
    clean = _clips01(17)
    mod = torch.from_numpy(((np.random.RandomState(3).rand(2 * T, 3, HW, HW) * 2 - 1)
                            * 0.5 * EPS).astype(np.float32))
    runner = ensemble.make_ensemble_parallel_runner(
        pb, ensemble.ensemble_mesh([CPU] * 4, model=4), steps=2, return_modifier=True)
    adv, costs, out = runner(clean, mod_init=mod)
    r_adv, r_costs, _, r_out = _ref_ensemble(pb, clean, m_size=4, cols=1, steps=2, mod_init=mod)
    for got, want in ((adv, r_adv), (costs, r_costs), (out, r_out)):
        _equal(got, want)
    assert out.shape == mod.shape and not torch.equal(out, mod)


# -- the Grad-CAM evaluator -------------------------------------------------------------------

CAM_HW = 64  # tiny AlexNet's whole forward needs 64²


def _cam_twins(name, seed=0):
    module, taps = build_image_model(name, 4, tiny=True, truncate=False, input_hw=CAM_HW)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in module.named_parameters():
            if n.endswith("weight") and p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5)
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g) + (n.endswith("scale")))
    b = ImageModel(name, module.eval().requires_grad_(False), taps)
    jmodule, jtaps = jregistry.build_image_model(name, 4, truncate=False, tiny=True)
    return b, JImageModel(name, jmodule, {"params": convert.to_jax_params(module)}, jtaps)


def _cam_frames(seed, n=2):
    x = np.random.RandomState(seed).rand(n, CAM_HW, CAM_HW, 3).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("name", ["resnet", "squeezenet"])
def test_cam_evaluator_equals_cam_raw_and_matches_jax(name):
    b, jb = _cam_twins(name)
    evaluator = gradcam.CamEvaluator(b)
    for seed in (1, 2):
        x, xt = _cam_frames(seed)
        got = evaluator(xt)
        _equal(got, gradcam._cam_raw(b, xt, None)[0])
        jcam, _ = jax.jit(lambda p, f: jgradcam._cam_raw(dataclasses.replace(jb, params=p), f,
                                                         None))(jb.params, jnp.asarray(x))
        want = np.asarray(jcam)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    assert len(evaluator.steps) == 1
    evaluator(_cam_frames(3, n=1)[1])
    assert len(evaluator.steps) == 2


def test_cli_cam_fns_are_one_evaluator_a_bundle():
    b, _ = _cam_twins("resnet")
    fns = gradcam_cli._cam_fns([b, b])
    assert all(isinstance(f, gradcam.CamEvaluator) for f in fns) and fns[0] is not fns[1]
    clips = np.asarray(pixel.normalize(_clips01(4, b=2, t=2, hw=CAM_HW), channel_axis=1))
    cams, frames = gradcam_cli.average_cam_for_clips(clips, fns, CAM_HW, CPU)
    eager = gradcam_cli.average_cam_for_clips(clips, gradcam_cli._cam_fns([b], graphs=False),
                                              CAM_HW, CPU)[0]
    np.testing.assert_array_equal(cams, eager)
    assert cams.shape == (2, 2, CAM_HW, CAM_HW) and frames.shape == (2, 2, CAM_HW, CAM_HW, 3)
