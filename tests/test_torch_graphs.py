"""The port's compiled loops (``i2v_tpu_torch.utils.graphs``): each attack
step and evaluation forward as a capture-ready step, a CUDA graph on a card
and eager on the CPU.

On the CPU the capture-ready steps run eagerly, so each engine is held here,
bit for bit, to the eager loop the port ran before its steps became graphs:
a Python loop with ``torch.optim.Adam(foreach=False)`` (or the optax form,
``parallel.sharded._AdamMu``) stepping leaf tensors, records appended to a
list. Those loops are restated below (``_ref_*``) over the port's unchanged
building blocks. Also held:
  - the device-table Adam against both eager optimizers over 60 steps, bit
    for bit, and its state round trip;
  - no step reads anything back to the host: one step of each runs under a
    dispatch mode that raises on ``aten._local_scalar_dense``,
    ``aten.nonzero`` and ``aten.is_nonzero`` (DIFGSM, TemporalTranslation,
    the model-axis runner and the Grad-CAM evaluator among them, whose
    eager forms tests/test_torch_graphs_rest.py holds them to);
  - a second batch of one shape reuses the first's loop (one cache entry)
    and gives what a fresh engine gives;
  - the runner and BIM against the JAX package at the tolerances of
    tests/test_torch_sharded.py and tests/test_torch_whitebox.py (costs
    rtol 1e-5), on a second batch through the cached loop;
  - ILAF's truncated video models: the tap equal to the full model's, the
    cost trajectory unchanged;
  - data-parallel evaluation keeps its replicas across calls.
Tests that need a card carry the ``gpu`` marker and skip elsewhere.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

import i2v_tpu.attacks as jattacks  # noqa: E402
from i2v_tpu.models import get_image_models as jget_image_models  # noqa: E402
from i2v_tpu.models import i3d as ji3d  # noqa: E402
from i2v_tpu.models.api import VideoModel as JVideoModel  # noqa: E402
from i2v_tpu.parallel import attack_mesh as jattack_mesh  # noqa: E402
from i2v_tpu.parallel import sharded as jsharded  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.attacks import core  # noqa: E402
from i2v_tpu_torch.attacks.i2v import MODIFIER_INIT, _collect_taps  # noqa: E402
from i2v_tpu_torch.eval import gradcam, transfer  # noqa: E402
from i2v_tpu_torch.models import (ImageModel, VideoModel, build_image_model,  # noqa: E402
                                  get_video_model, i3d, tap_keys_for)
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402
from i2v_tpu_torch.models.registry import random_init_  # noqa: E402
from i2v_tpu_torch.ops import grads as grad_ops  # noqa: E402
from i2v_tpu_torch.ops import kernels, pixel  # noqa: E402
from i2v_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from i2v_tpu_torch.parallel import ensemble, multigrid, replicas, sharded  # noqa: E402
from i2v_tpu_torch.utils import artifacts, graphs  # noqa: E402

EPS = 16 / 255
HW, T = 32, 4
STEPS = 3
CPU = torch.device("cpu")


def _image_models(depths, seed=0):
    out = []
    for i, (name, d) in enumerate(depths.items()):
        module, taps = build_image_model(name, d, tiny=True, input_hw=HW)
        random_init_(module, torch.Generator().manual_seed(seed + i))
        out.append(ImageModel(name, module.eval().requires_grad_(False), taps))
    return out


@pytest.fixture(scope="module")
def i2v_models():
    return _image_models({"resnet": 2})


@pytest.fixture(scope="module")
def aens_models():
    return _image_models({"resnet": [1, 2]})


@pytest.fixture(scope="module")
def video():
    return get_video_model("i3d_resnet50", device="cpu", tiny=True)


def _clips01(seed, b=2, t=T, hw=HW):
    return torch.from_numpy(np.random.RandomState(seed).rand(b, 3, t, hw, hw).astype(np.float32))


def _equal(a, b):
    a, b = (x.detach() if isinstance(x, torch.Tensor) else x for x in (a, b))
    assert torch.equal(a, b), float((a - b).abs().max())


# -- the eager loops the port ran before its steps became graphs --------------------

def _ref_runner(models, clean01, *, steps, frame_chunk=None, adaptive=False, momentum=0.0,
                mu_dtype=None, n_pos=1, mod_init=None, step_size=0.005):
    """The runner's old loop: positions as the runner cuts them, one leaf
    modifier a position, torch.optim.Adam (or _AdamMu), costs in a list."""
    n_taps = sum(len(m.tap_keys) for m in models)
    b, _, t = clean01.shape[:3]
    frames = pixel.flatten_clip_to_frames(clean01)
    chunk = sharded._local_chunk(frame_chunk, b * t, frames.shape[2:],
                                 sharded.compute_dtype_of(models), n_pos)
    positions = [sharded._position(models, f, chunk, None, slice(0, n_taps))
                 for f in sharded._slices(frames, n_pos)]
    grad_of = functools.partial(sharded._position_grad, epsilon=EPS, adaptive=adaptive,
                                coef_ce=False, n_taps=n_taps, remat=False)
    inits = None if mod_init is None else sharded._slices(mod_init, n_pos)
    mods = [(torch.full_like(p.frames, MODIFIER_INIT) if inits is None else inits[k].clone())
            .requires_grad_(True) for k, p in enumerate(positions)]
    if mu_dtype is None:
        step = torch.optim.Adam(mods, lr=step_size, betas=(0.9, 0.999), eps=1e-8,
                                foreach=False, fused=False).step
    else:
        opts = [sharded._AdamMu(m, step_size, mu_dtype, None) for m in mods]

        def step():
            for o in opts:
                o.step()
    coeffs = prev = torch.ones(n_taps)
    costs = []
    for _ in range(steps):
        c_now = (torch.softmax(torch.softmax(prev, 0) + momentum * coeffs, 0)
                 if adaptive else None)
        cost = signal = None
        grads = []
        for pos, m in zip(positions, mods):
            c, s, g = grad_of(pos, m, c_now)
            grads.append(g)
            cost = c if cost is None else cost + c
            signal = s if signal is None else signal + s
        for m, g in zip(mods, grads):
            m.grad = g
        step()
        costs.append(cost)
        if adaptive:
            coeffs, prev = c_now, signal
    adv = torch.cat([kernels.rebuild_adv(p.frames, m.detach(), EPS)
                     for p, m in zip(positions, mods)])
    return (pixel.unflatten_frames_to_clip(adv, b), torch.stack(costs),
            torch.cat([m.detach() for m in mods]))


def _ref_adam_engine(atk, clean01):
    """run_adam_modifier_attack's old loop over an attack's loss."""
    frames = pixel.flatten_clip_to_frames(clean01)
    with torch.no_grad():
        loss_fn = atk._make_loss(_collect_taps(atk.models, frames))
    modifier = torch.full_like(frames, MODIFIER_INIT, requires_grad=True)
    opt = torch.optim.Adam([modifier], lr=atk.step_size, betas=(0.9, 0.999), eps=1e-8,
                           foreach=False, fused=False)
    state, records = atk._state0(), []
    for _ in range(atk.steps):
        opt.zero_grad(set_to_none=True)
        cost, (state, record) = loss_fn(kernels.rebuild_adv(frames, modifier, atk.epsilon), state)
        cost.backward()
        opt.step()
        records.append(tuple(r.detach() for r in record) if isinstance(record, tuple)
                       else record.detach())
    with torch.no_grad():
        adv = kernels.rebuild_adv(frames, modifier, atk.epsilon)
    if isinstance(records[0], tuple):
        records = tuple(torch.stack(r) for r in zip(*records))
    else:
        records = torch.stack(records)
    return pixel.unflatten_frames_to_clip(adv, clean01.shape[0]), records, state


def _ref_ilaf(atk, adv01, clean01):
    cost_fn = atk.make_cost(adv01, clean01)
    alpha32 = float(np.float32(atk.step_size))
    modifier = adv01 - clean01
    costs = []
    for _ in range(atk.steps):
        m = modifier.detach().requires_grad_(True)
        cost = cost_fn(m)
        (g,) = torch.autograd.grad(cost, m)
        modifier = modifier - alpha32 * pixel.sign_keep_nan(g)
        costs.append(cost.detach())
    with torch.no_grad():
        out = kernels.rebuild_adv(clean01, modifier, atk.epsilon)
    return out, torch.stack(costs)


def _ref_sign(grad_fns, clean, labels, cfg, smooth_fn=None, cost_sum=False):
    """run_sign_attack_pieces' old loop (no random draws)."""
    k = len(clean)
    fns = [core._chunked(fn, c.shape[0], cfg.batch_chunk)
           if cfg.batch_chunk and cfg.batch_chunk < c.shape[0] else fn
           for fn, c in zip(grad_fns, clean)]
    adv = list(clean)
    mom = [torch.zeros_like(c) for c in clean] if cfg.use_momentum else None
    costs = []
    for _ in range(cfg.steps):
        step_costs, gs = [], []
        for fn, a, lab in zip(fns, adv, labels):
            cost, g = fn(a, lab, None)
            if k > 1 and not cost_sum:
                g = g / k
            if smooth_fn is not None:
                g = smooth_fn(g)
            step_costs.append(cost.detach())
            gs.append(g)
        if cfg.grad_norm == "l1" and k > 1:
            total = torch.stack([torch.sum(torch.abs(g)) for g in gs]).sum()
            gs = [grad_ops.l1_normalize(g, total) for g in gs]
        else:
            gs = [core._apply_grad_norm(g, cfg.grad_norm) for g in gs]
        for i, g in enumerate(gs):
            if cfg.use_momentum:
                g = g + mom[i] * cfg.decay
                mom[i] = g
            adv[i] = kernels.sign_step_project(adv[i], g, clean[i], cfg.alpha, cfg.epsilon)
        stacked = torch.stack(step_costs)
        costs.append(stacked[0] if k == 1 else stacked.sum(0) if cost_sum else stacked.mean(0))
    return adv, torch.stack(costs)


# -- (a) each capture-ready step against the old eager loop, bit for bit -----------

@pytest.mark.parametrize("kw", [
    {},
    {"frame_chunk": 4},
    {"mu_dtype": torch.bfloat16},
    {"frame_chunk": 4, "mu_dtype": torch.bfloat16},
], ids=["whole", "chunked", "mu_bf16", "chunked-mu_bf16"])
def test_runner_equals_the_eager_loop(i2v_models, kw):
    clean = _clips01(1)
    adv, costs, mod = sharded.make_sharded_i2v_runner(
        i2v_models, steps=STEPS, return_modifier=True, **kw)(clean)
    r_adv, r_costs, r_mod = _ref_runner(i2v_models, clean, steps=STEPS, **kw)
    for got, want in ((adv, r_adv), (costs, r_costs), (mod, r_mod)):
        _equal(got, want)


@pytest.mark.parametrize("chunk", [None, 4], ids=["whole", "chunked"])
def test_aens_runner_equals_the_eager_loop(aens_models, chunk):
    clean = _clips01(2)
    runner = sharded.make_sharded_i2v_runner(aens_models, steps=STEPS, adaptive=True,
                                             aens_momentum=0.5, frame_chunk=chunk)
    adv, costs = runner(clean)
    r_adv, r_costs, _ = _ref_runner(aens_models, clean, steps=STEPS, adaptive=True,
                                    momentum=0.5, frame_chunk=chunk)
    _equal(costs, r_costs)
    _equal(adv, r_adv)


def test_mesh_runner_over_two_cpu_positions_equals_the_eager_loop(aens_models):
    clean = _clips01(3)
    mesh = pmesh.attack_mesh([CPU] * 2)
    for adaptive in (False, True):
        runner = sharded.make_sharded_i2v_runner(aens_models, mesh, steps=STEPS,
                                                 adaptive=adaptive, aens_momentum=0.5)
        adv, costs = runner(clean)
        r_adv, r_costs, _ = _ref_runner(aens_models, clean, steps=STEPS, adaptive=adaptive,
                                        momentum=0.5, n_pos=2)
        _equal(costs, r_costs)
        _equal(adv, r_adv)


def test_multigrid_equals_the_eager_loops(i2v_models):
    clean = _clips01(4, hw=2 * HW)
    models = _image_models({"resnet": 2}, seed=3)
    adv, costs = multigrid.make_multigrid_i2v_runner(models, steps=4, coarse_steps=2)(clean)
    _, c_costs, c_mod = _ref_runner(models, multigrid.downsample_clips(clean, 2), steps=2)
    f_adv, f_costs, _ = _ref_runner(models, clean, steps=2,
                                    mod_init=multigrid.upsample_modifier(c_mod, 2))
    _equal(costs, torch.cat([c_costs, f_costs]))
    _equal(adv, f_adv)


@pytest.mark.parametrize("method", ["i2v", "dr", "aens"])
def test_adam_engine_equals_the_eager_loop(i2v_models, aens_models, method):
    clean = _clips01(5)
    make = {
        "i2v": lambda: attacks.ImageGuidedFMDirection_Adam(i2v_models, 0.005, steps=STEPS),
        "dr": lambda: attacks.ImageGuidedStd_Adam(i2v_models, 0.005, steps=STEPS),
        "aens": lambda: attacks.AENS_I2V_MF(aens_models, 0.005, momentum=0.5, steps=STEPS),
    }[method]
    adv, records, state = make()._run(clean)
    r_adv, r_records, r_state = _ref_adam_engine(make(), clean)
    _equal(adv, r_adv)
    for got, want in zip(*(r if isinstance(r, tuple) else (r,) for r in (records, r_records))):
        _equal(got, want)
    for got, want in zip(state or (), r_state or ()):
        _equal(got, want)


def test_ilaf_equals_the_eager_loop(video):
    bundle = video.with_taps(tap_keys_for("i3d_resnet50", "ilaf"))
    clean = _clips01(6, b=1, t=8)
    adv = torch.clamp(clean + 0.8 * EPS * torch.sign(torch.randn(clean.shape,
                      generator=torch.Generator().manual_seed(0))), 0, 1)
    out, costs = attacks.ILAF(bundle, "i3d", steps=STEPS)._fine_tune(adv, clean)
    r_out, r_costs = _ref_ilaf(attacks.ILAF(bundle, "i3d", steps=STEPS), adv, clean)
    _equal(out, r_out)
    _equal(costs, r_costs)


SIGN_METHODS = {
    "BIM": lambda m: attacks.BIM(m, steps=STEPS),
    "MIFGSM": lambda m: attacks.MIFGSM(m, steps=STEPS),
    "SGM": lambda m: attacks.SGM(m, steps=STEPS, gamma=0.2),
    "SGM-momentum": lambda m: attacks.SGM(m, steps=STEPS, gamma=0.2, momentum=True),
    "SIM": lambda m: attacks.SIM(m, steps=2, scale_steps=3),
    "TIFGSM3D": lambda m: attacks.TIFGSM3D(m, steps=STEPS, kernlen=3),
    "TAP": lambda m: attacks.TAP(m, steps=STEPS),
}
# the steps that read a draw table: held under the no-host-read mode only
# (tests/test_torch_graphs_rest.py holds them to their old eager loop)
DRAWN = {
    "DIFGSM": lambda m: attacks.DIFGSM(m, steps=STEPS),
    "DIFGSM-momentum": lambda m: attacks.DIFGSM(m, steps=STEPS, momentum=True),
}


def _ref_of(atk, clean_pieces, label_pieces):
    if isinstance(atk, attacks.TAP):
        cfg = core.SignAttackConfig(epsilon=atk.epsilon, steps=atk.steps,
                                    step_size=atk.step_size)
        w = 1.0 / len(clean_pieces)
        fns = [atk._build_grad_fn(c, atk.model, w) for c in clean_pieces]
        return _ref_sign(fns, clean_pieces, label_pieces, cfg, cost_sum=True)
    fns = [atk._build_grad_fn(atk.model) for _ in clean_pieces]
    return _ref_sign(fns, clean_pieces, label_pieces, atk.cfg, atk._build_smooth_fn())


@pytest.mark.parametrize("name", sorted(SIGN_METHODS))
def test_sign_engine_equals_the_eager_loop(video, name):
    clean = _clips01(7, t=8)
    labels = torch.tensor([1, 3])
    adv, costs = SIGN_METHODS[name](video)._attack_pieces([clean], [labels], [CPU])
    r_adv, r_costs = _ref_of(SIGN_METHODS[name](video), [clean], [labels])
    _equal(adv[0], r_adv[0])
    _equal(costs, r_costs)


@pytest.mark.parametrize("name", ["BIM", "SGM-momentum", "TAP"])
def test_sign_engine_over_two_pieces_equals_the_eager_loop(video, name):
    """Two pieces: the cross-piece cost reduction, and for SGM with momentum
    the whole-batch L1 between each piece's two graphs."""
    clean = [_clips01(8, b=1, t=8), _clips01(9, b=1, t=8)]
    labels = [torch.tensor([1]), torch.tensor([3])]
    adv, costs = SIGN_METHODS[name](video)._attack_pieces(clean, labels, [CPU, CPU])
    r_adv, r_costs = _ref_of(SIGN_METHODS[name](video), clean, labels)
    for got, want in zip(adv, r_adv):
        _equal(got, want)
    _equal(costs, r_costs)


def test_single_pass_equals_the_eager_forwards(tmp_path):
    bundles = {n: get_video_model(n, device="cpu", tiny=True)
               for n in ("i3d_resnet50", "slowfast_resnet50", "tpn_resnet50")}
    clips = [np.asarray(pixel.normalize(_clips01(10 + i, t=8), channel_axis=1))
             for i in range(2)]
    for label in range(4):
        artifacts.save_adv_clip(str(tmp_path), label, clips[label // 2][label % 2])
    batches = artifacts.batch_files(artifacts.list_adv_files(str(tmp_path)), 2)
    preds, labels, _ = transfer.single_pass_eval(bundles, batches, str(tmp_path),
                                                 log=lambda *_: None)
    assert labels == [0, 1, 2, 3]
    for name, b in bundles.items():
        with torch.no_grad():
            want = [transfer.accuracy_and_preds(b.apply_norm(torch.from_numpy(c)),
                                                torch.tensor([2 * i, 2 * i + 1]))[1]
                    for i, c in enumerate(clips)]
        assert preds[name] == torch.cat(want).tolist()
        got = replicas.replicas_for(b).logits(torch.from_numpy(clips[1]), None)
        with torch.no_grad():
            _equal(got, b.apply_norm(torch.from_numpy(clips[1])))


# -- (c) the device-table Adam ---------------------------------------------------------

def _grads(n=60, shape=(3, 5, 7, 11)):
    rng = np.random.RandomState(12)
    return [torch.from_numpy((rng.randn(*shape) * 10.0 ** rng.uniform(-6, 0, shape))
                             .astype(np.float32)) for _ in range(n)]


def test_table_adam_is_torch_adam_bit_for_bit_over_60_steps():
    grads = _grads()
    p0 = torch.from_numpy(np.random.RandomState(13).randn(3, 5, 7, 11).astype(np.float32))
    ref = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([ref], lr=0.005, betas=(0.9, 0.999), eps=1e-8, foreach=False)
    table = p0.clone()
    adam = graphs.TableAdam(table, 0.005, len(grads))
    adam.reset()
    for g in grads:
        ref.grad = g.clone()
        opt.step()
        adam.step(g)
        _equal(table, ref)
    st = opt.state[ref]
    count, m, v = adam.state()
    assert count.dtype == st["step"].dtype == torch.float32 and float(count) == 60
    _equal(m, st["exp_avg"])
    _equal(v, st["exp_avg_sq"])


@pytest.mark.parametrize("mu_dtype", [torch.bfloat16, torch.float32])
def test_table_adam_is_the_optax_form_bit_for_bit_over_60_steps(mu_dtype):
    grads = _grads()
    p0 = torch.full((3, 5, 7, 11), MODIFIER_INIT)
    ref = p0.clone()
    eager = sharded._AdamMu(ref, 0.005, mu_dtype, None)
    table = p0.clone()
    adam = graphs.TableAdam(table, 0.005, len(grads), mu_dtype=mu_dtype)
    adam.reset()
    for g in grads:
        ref.grad = g
        eager.step()
        adam.step(g)
        _equal(table, ref)
    for got, want in zip(adam.state(), eager.io_state()):
        _equal(got, want)


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16], ids=["torch", "optax-bf16"])
def test_table_adam_state_round_trip_resumes_exactly(mu_dtype):
    grads = _grads(12)
    p0 = torch.full((3, 5, 7, 11), MODIFIER_INIT)
    whole = p0.clone()
    one = graphs.TableAdam(whole, 0.005, 12, mu_dtype=mu_dtype)
    one.reset()
    for g in grads:
        one.step(g)
    part = p0.clone()
    state = None
    for seg in (grads[:5], grads[5:]):
        adam = graphs.TableAdam(part, 0.005, len(seg), mu_dtype=mu_dtype)
        adam.reset(state)
        for g in seg:
            adam.step(g)
        state = adam.state()
    _equal(part, whole)
    for got, want in zip(state, one.state()):
        _equal(got, want)


def test_runner_opt_state_io_round_trips_through_segments(i2v_models):
    clean = _clips01(14)
    kw = dict(frame_chunk=4, return_modifier=True, opt_state_io=True)
    full = sharded.make_sharded_i2v_runner(i2v_models, steps=4, **kw)(clean)
    seg = sharded.make_sharded_i2v_runner(i2v_models, steps=2, **kw)
    first = seg(clean)
    second = seg(clean, mod_init=first[2], opt_init=first[3])
    assert len(seg.loops) == 1
    _equal(torch.cat([first[1], second[1]]), full[1])
    _equal(second[2], full[2])
    for got, want in zip(second[3], full[3]):
        _equal(got, want)


# -- (d) no step reads back to the host -------------------------------------------------

class _NoHostReads(torch.utils._python_dispatch.TorchDispatchMode):
    BANNED = ("_local_scalar_dense", "nonzero", "is_nonzero")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.BANNED:
            raise AssertionError(f"a host read inside a capture-ready step: {func}")
        return func(*args, **(kwargs or {}))


def _steps_of(kind, i2v_models, aens_models, video):
    """(reset, step) of one capture-ready step of each engine, after a run
    made its buffers."""
    clean = _clips01(15)
    if kind.startswith("runner"):
        mesh = pmesh.attack_mesh([CPU] * 2) if kind == "runner-mesh" else None
        runner = sharded.make_sharded_i2v_runner(
            aens_models, mesh, steps=2, adaptive=True, frame_chunk=4,
            mu_dtype=torch.bfloat16 if kind == "runner-mu" else None)
        runner(clean)
        loop = next(iter(runner.loops.values()))
        return (lambda: loop.reset(None, None, torch.ones(2)),
                [g.step for g in loop.graphs])
    if kind == "adam-engine":
        atk = attacks.AENS_I2V_MF(aens_models, 0.005, momentum=0.5, steps=2)
        atk._run(clean)
        loop = next(iter(atk._loops.values()))[0]
        return loop.adam.reset, [loop.graph.step]
    clips = _clips01(16, t=8)
    if kind == "ilaf":
        atk = attacks.ILAF(video.with_taps(tap_keys_for("i3d_resnet50", "ilaf")), "i3d", steps=2)
        atk._fine_tune(torch.clamp(clips + 0.03, 0, 1), clips)
        loop = next(iter(atk._loops.values()))
        return loop.k.zero_, [loop.graph.step]
    if kind == "eval":
        r = replicas.Replicas(video)
        r.predict(clips, None, torch.tensor([0, 1]))
        f = next(iter(r._forwards.values()))
        return (lambda: None), [f.graph.step]
    if kind.startswith("ensemble"):
        models = _image_models({"resnet": [1, 2], "vgg": [1, 2]})
        runner = ensemble.make_ensemble_parallel_runner(
            models, ensemble.ensemble_mesh([CPU] * 4, model=2), steps=2,
            adaptive=kind == "ensemble-aens", frame_chunk=4)
        runner(clean)
        loop = next(iter(runner.loops.values()))
        return (lambda: loop.reset(None, None, torch.ones(4)),
                [g.step for g in loop.graphs + loop.adam_graphs])
    if kind == "cam":
        module, taps = build_image_model("resnet", 2, tiny=True, truncate=False, input_hw=HW)
        random_init_(module, torch.Generator().manual_seed(0))
        evaluator = gradcam.CamEvaluator(ImageModel("resnet", module.eval().requires_grad_(False),
                                                    taps))
        evaluator(pixel.flatten_clip_to_frames(clean))
        return (lambda: None), [s.graph.step for s in evaluator.steps.values()]
    if kind.startswith("TT"):
        atk = attacks.TemporalTranslation(video, dict(kernlen=3, chunk=3, momentum=True,
                                                      move_type=kind[3:]), steps=2)
        atk._attack_pieces([clips], [torch.tensor([1, 2])], [CPU])
        loop = next(iter(atk._loops.values()))
        return (lambda: (loop.k.zero_(), [t.k.zero_() for t in loop.tables])), \
            [g.step for g in loop.grad_graphs]
    atk = {**SIGN_METHODS, **DRAWN}[kind](video)
    pieces = [clips[:1], clips[1:]] if kind in ("SGM-momentum", "DIFGSM-momentum") else [clips]
    labels = [torch.tensor([1]), torch.tensor([2])][:len(pieces)] if len(pieces) > 1 \
        else [torch.tensor([1, 2])]
    atk._attack_pieces(pieces, labels, [CPU] * len(pieces))
    loop = next(iter(atk._loops.values()))
    return ((lambda: (loop.k.zero_(), [t.k.zero_() for t in loop.tables])),
            [g.step for g in loop.grad_graphs + loop.update_graphs])


@pytest.mark.parametrize("kind", ["runner", "runner-mu", "runner-mesh", "adam-engine", "ilaf",
                                  "BIM", "MIFGSM", "SGM-momentum", "SIM", "TIFGSM3D", "TAP",
                                  "eval", "DIFGSM", "DIFGSM-momentum", "TT-adj", "TT-random",
                                  "ensemble", "ensemble-aens", "cam"])
def test_no_capture_ready_step_reads_back_to_the_host(i2v_models, aens_models, video, kind):
    reset, steps = _steps_of(kind, i2v_models, aens_models, video)
    reset()
    with _NoHostReads():
        for step in steps:
            step()


def test_the_dispatch_mode_does_catch_a_host_read():
    with pytest.raises(AssertionError, match="host read"):
        with _NoHostReads():
            torch.ones(2).sum().item()


def test_table_adam_step_reads_nothing_back():
    p = torch.zeros(4)
    for mu_dtype in (None, torch.bfloat16):
        adam = graphs.TableAdam(p, 0.005, 2, mu_dtype=mu_dtype)
        adam.reset()
        with _NoHostReads():
            adam.step(torch.ones(4))


# -- (e) one cache entry a shape, and a clean reset --------------------------------------

def test_runner_second_batch_reuses_its_loop_and_equals_a_fresh_runner(aens_models):
    kw = dict(steps=STEPS, frame_chunk=4)
    runner = sharded.make_sharded_i2v_runner(aens_models, **kw)
    runner(_clips01(17))
    adv, costs = runner(_clips01(18))
    assert len(runner.loops) == 1
    f_adv, f_costs = sharded.make_sharded_i2v_runner(aens_models, **kw)(_clips01(18))
    _equal(costs, f_costs)
    _equal(adv, f_adv)
    runner(_clips01(19, b=1))     # another shape, another loop
    assert len(runner.loops) == 2


def test_adam_engine_second_batch_reuses_its_loop(i2v_models):
    atk = attacks.ImageGuidedFML2_Adam_MultiModels(i2v_models, steps=STEPS)
    atk._run(_clips01(20))
    adv, costs, _ = atk._run(_clips01(21))
    assert len(atk._loops) == 1
    f_adv, f_costs, _ = attacks.ImageGuidedFML2_Adam_MultiModels(
        i2v_models, steps=STEPS)._run(_clips01(21))
    _equal(costs, f_costs)
    _equal(adv, f_adv)


def test_ilaf_second_batch_reuses_its_loop(video):
    bundle = video.with_taps(tap_keys_for("i3d_resnet50", "ilaf"))
    pairs = [(torch.clamp(c + 0.04 * torch.sign(c - 0.5), 0, 1), c)
             for c in (_clips01(22, b=1, t=8), _clips01(23, b=1, t=8))]
    atk = attacks.ILAF(bundle, "i3d", steps=STEPS)
    atk._fine_tune(*pairs[0])
    out, costs = atk._fine_tune(*pairs[1])
    assert len(atk._loops) == 1
    f_out, f_costs = attacks.ILAF(bundle, "i3d", steps=STEPS)._fine_tune(*pairs[1])
    _equal(costs, f_costs)
    _equal(out, f_out)


@pytest.mark.parametrize("name", ["BIM", "MIFGSM", "TAP"])
def test_sign_engine_second_batch_reuses_its_loop(video, name):
    atk = SIGN_METHODS[name](video)
    atk._attack_pieces([_clips01(24, t=8)], [torch.tensor([0, 1])], [CPU])
    adv, costs = atk._attack_pieces([_clips01(25, t=8)], [torch.tensor([2, 3])], [CPU])
    assert len(atk._loops) == 1
    f_adv, f_costs = SIGN_METHODS[name](video)._attack_pieces(
        [_clips01(25, t=8)], [torch.tensor([2, 3])], [CPU])
    _equal(costs, f_costs)
    _equal(adv[0], f_adv[0])


def test_eval_forward_second_batch_reuses_its_forward(video):
    r = replicas.Replicas(video)
    x = [pixel.normalize(_clips01(26 + i, t=8), channel_axis=1) for i in range(2)]
    r.predict(x[0], None, torch.tensor([0, 1]))
    _, acc, preds = r.predict(x[1], None, torch.tensor([2, 3]))
    assert len(r._forwards) == 1
    _, f_acc, f_preds = replicas.Replicas(video).predict(x[1], None, torch.tensor([2, 3]))
    _equal(preds, f_preds)
    _equal(acc, f_acc)


# -- (b) against the JAX package, through the cached loops ----------------------------------

def test_runner_second_batch_matches_jax():
    depths = {"resnet": 2}
    jb = jget_image_models(list(depths), depths, tiny=True, input_hw=HW)
    module, taps = build_image_model("resnet", 2, tiny=True, input_hw=HW)
    from_jax_params(module, jax.tree_util.tree_map(np.asarray, jb[0].params))
    pb = [ImageModel("resnet", module.eval().requires_grad_(False), taps)]
    clips = [np.asarray(_clips01(27 + i, t=8)) for i in range(2)]
    jrunner = jsharded.make_sharded_i2v_runner(jb, jattack_mesh(jax.devices()[:1]), steps=STEPS,
                                               frame_chunk=4)
    runner = sharded.make_sharded_i2v_runner(pb, steps=STEPS, frame_chunk=4)
    for c in clips:
        want = np.asarray(jrunner(jnp.asarray(c))[1])
        got = runner(torch.from_numpy(c))[1].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(runner.loops) == 1


def test_bim_second_batch_matches_jax():
    clip = (2, 3, 8, 32, 32)
    jmod = ji3d.i3d_tiny()
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.zeros((1,) + clip[1:]))
    taps = ("res_layer1", "res_layer2")
    jb = JVideoModel("i3d_resnet50", jmod, params, taps)
    module = from_jax_params(i3d.i3d_tiny(), jax.tree_util.tree_map(np.asarray, params))
    pb = VideoModel("i3d_resnet50", module.eval().requires_grad_(False), taps)
    jatk, atk = jattacks.BIM(jb, steps=4), attacks.BIM(pb, steps=4)
    labels = np.asarray([1, 3])
    for seed in (30, 31):
        clips01 = np.random.RandomState(seed).rand(*clip).astype(np.float32)
        videos = np.asarray(pixel.normalize(torch.from_numpy(clips01), channel_axis=1))
        jatk.loss_info, atk.loss_info = {}, {}
        jatk(jnp.asarray(videos), jnp.asarray(labels), video_names=["v"])
        atk(videos, labels, video_names=["v"])
        costs = [np.asarray([float(a.loss_info["v"][i]["cost"]) for i in range(4)])
                 for a in (jatk, atk)]
        np.testing.assert_allclose(costs[1], costs[0], rtol=1e-5)
    assert len(atk._loops) == 1


# -- ILAF's truncated models ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["i3d_resnet50", "slowfast_resnet50", "tpn_resnet50"])
def test_a_truncated_video_model_gives_the_full_models_tap(name):
    taps = tap_keys_for(name, "ilaf")
    full = get_video_model(name, device="cpu", tiny=True, taps=taps)
    cut = get_video_model(name, device="cpu", tiny=True, taps=taps, truncate=True)
    assert full.tap_keys == cut.tap_keys == taps
    n_full, n_cut = (sum(p.numel() for p in b.module.parameters()) for b in (full, cut))
    assert n_cut < n_full / 2
    clip = _clips01(32, b=1, t=8)
    with torch.no_grad():
        logits, got = cut.apply01_taps(clip)
        _, want = full.apply01_taps(clip)
    assert logits is None
    for g, w in zip(got, want):
        _equal(g, w)
    with pytest.raises(ValueError, match="truncated"):
        cut.apply01(clip)


def test_ilaf_costs_are_unchanged_on_the_truncated_model():
    taps = tap_keys_for("i3d_resnet50", "ilaf")
    full = get_video_model("i3d_resnet50", device="cpu", tiny=True, taps=taps)
    cut = get_video_model("i3d_resnet50", device="cpu", tiny=True, taps=taps, truncate=True)
    clean = _clips01(33, b=1, t=8)
    adv = torch.clamp(clean + 0.05 * torch.sign(clean - 0.5), 0, 1)
    out_f, costs_f = attacks.ILAF(full, "i3d", steps=STEPS)._fine_tune(adv, clean)
    out_c, costs_c = attacks.ILAF(cut, "i3d", steps=STEPS)._fine_tune(adv, clean)
    _equal(costs_c, costs_f)
    _equal(out_c, out_f)


# -- replicas kept across evaluations ---------------------------------------------------------

def test_data_parallel_eval_keeps_its_replicas_across_calls(tmp_path, monkeypatch):
    bundle = get_video_model("i3d_resnet50", device="cpu", tiny=True)
    for label in range(4):
        artifacts.save_adv_clip(str(tmp_path), label, np.asarray(pixel.normalize(
            _clips01(34 + label, b=1, t=8)[0], channel_axis=0)))
    batches = artifacts.batch_files(artifacts.list_adv_files(str(tmp_path)), 2)
    # a second "device" that moves tensors nowhere: the replica is a real copy
    mesh = pmesh.attack_mesh([CPU, torch.device("cpu", 1)])
    copies = []
    real = copy.deepcopy
    monkeypatch.setattr(replicas.copy, "deepcopy", lambda x, *a: copies.append(1) or real(x, *a))
    outs = [transfer.reference_eval(bundle, batches, str(tmp_path), mesh=mesh,
                                    log=lambda *_: None) for _ in range(2)]
    assert len(copies) == 1
    assert outs[0][:2] == outs[1][:2] and outs[0][1] == [0, 1, 2, 3]
    held = replicas.replicas_for(bundle, mesh)
    assert held is replicas.replicas_for(bundle, mesh)
    assert dataclasses.replace(bundle) is not bundle  # the cache rides the bundle object


# -- the card ---------------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs are captured there only")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_runner_captures_and_replays_on_the_card(cuda, i2v_models):
    models = [dataclasses.replace(m, module=copy.deepcopy(m.module).to(cuda)) for m in i2v_models]
    clean = _clips01(40).to(cuda)
    eager = sharded.make_sharded_i2v_runner(models, steps=4, graphs=False)(clean)[1]
    before = graphs.captures["graphs"]
    kernels.reset_launches()
    runner = sharded.make_sharded_i2v_runner(models, steps=4)
    graphed = runner(clean)[1]
    assert graphs.captures["graphs"] == before + 1
    assert kernels.launches["rebuild_fwd"] == 5 and kernels.launches["rebuild_bwd"] == 4
    assert float(graphed[0]) == float(eager[0])
    np.testing.assert_allclose(graphed.cpu().numpy(), eager.cpu().numpy(), rtol=1e-4)


@pytest.mark.gpu
def test_bim_captures_and_replays_on_the_card(cuda, video):
    bundle = dataclasses.replace(video, module=copy.deepcopy(video.module).to(cuda))
    clean = _clips01(41, t=8).to(cuda)
    labels = torch.tensor([1, 2], device=cuda)
    eager = attacks.BIM(bundle, steps=4, graphs=False)._attack_pieces([clean], [labels], [cuda])
    kernels.reset_launches()
    graphed = attacks.BIM(bundle, steps=4)._attack_pieces([clean], [labels], [cuda])
    assert kernels.launches["sign_step"] == 4
    assert float(graphed[1][0]) == float(eager[1][0])
