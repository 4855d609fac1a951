"""bfloat16 compute in the port against the JAX package's, on the CPU.

The same tiny weights go to both packages: each port model is drawn in
float32 from a seed, ``to_jax_params`` carries it to the JAX module (built
with ``dtype=jnp.bfloat16``), and ``from_jax_params`` into the port's
bfloat16 twin. Inputs are numpy arrays from a seed. The JAX forwards are
jitted, all image models in one program and all video models in another.

Tolerances:
  - a bfloat16 output (logits, every tap) against JAX's bfloat16 output:
    ‖port_bf16 − jax_bf16‖ ≤ 2·‖jax_bf16 − f32‖ + 1e-3·‖f32‖, with f32 the
    port's float32 output (JAX's float32 output to 1e-5, the other
    tests/test_torch_*.py files). torch rounds a biased conv or linear once
    and some of XLA's CPU kernels twice, and they sum in other orders: the
    port's bfloat16 error is held to twice bfloat16's own;
  - the runner with a bfloat16 ensemble: its three costs within rtol 2e-4 of
    JAX's (a step moves the cost by ~4e-3 of itself; the float32 runners
    agree to 1e-5, tests/test_torch_sharded.py);
  - ``mu_dtype``: the optimizer alone against ``optax.adam(mu_dtype=bf16)``
    on the same gradients, the first moment bit for bit and the modifier to
    1e-8; the runner's costs within rtol 1e-5 of JAX's; resumed segments
    bit for bit;
  - the evaluation reports: byte for byte, on clips whose bfloat16 top-1
    margin is above 0.05 (the port's and JAX's bfloat16 logits differ by far
    less; ties are legitimately ambiguous in bfloat16), and a planted
    bfloat16 tie takes the first index in both packages.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from flax import linen as fnn  # noqa: E402
from i2v_tpu.eval import transfer as jtransfer  # noqa: E402
from i2v_tpu.models import registry as jregistry  # noqa: E402
from i2v_tpu.models import video_zoo as jvideo_zoo  # noqa: E402
from i2v_tpu.models.api import ImageModel as JImageModel  # noqa: E402
from i2v_tpu.models.api import VideoModel as JVideoModel  # noqa: E402
from i2v_tpu.parallel import attack_mesh  # noqa: E402
from i2v_tpu.parallel import sharded as jsharded  # noqa: E402
from i2v_tpu_torch.cli import evaluate, evaluate_ucf101  # noqa: E402
from i2v_tpu_torch.eval import transfer  # noqa: E402
from i2v_tpu_torch.models import (ImageModel, build_image_model, convert,  # noqa: E402
                                  get_video_model)
from i2v_tpu_torch.models import vit  # noqa: E402
from i2v_tpu_torch.models.registry import random_init_  # noqa: E402
from i2v_tpu_torch.parallel import sharded  # noqa: E402
from i2v_tpu_torch.parallel.multigrid import make_multigrid_i2v_runner  # noqa: E402

BF16 = torch.bfloat16
HW = 32
EPS = 16 / 255
# truncated where the tap is all the ENS uses (VGG's and AlexNet's heads need 224²)
IMAGE = {"resnet": ([1, 2], False), "vgg": ([2, 3], True), "alexnet": ([1, 3], True),
         "squeezenet": ([1, 2], False), "densenet": ([1, 2], False), "vit": ([1, 2], False)}
VIDEO = ("i3d_resnet50", "slowfast_resnet50", "tpn_resnet50")
EVAL_MODELS = ("i3d_resnet50", "tpn_resnet50")   # through the CLI: one of each numerics
MARGIN = 0.05
CSV, JSON = "results_all_models_prediction.csv", "top1_acc_all_models.json"


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _within_bf16(got, want_bf16, f32):
    """‖got − want_bf16‖ ≤ 2·‖want_bf16 − f32‖ + 1e-3·‖f32‖."""
    got, want_bf16, f32 = _np(got), _np(want_bf16), _np(f32)
    assert got.shape == want_bf16.shape == f32.shape
    err = np.linalg.norm(got - want_bf16)
    bound = 2 * np.linalg.norm(want_bf16 - f32) + 1e-3 * np.linalg.norm(f32)
    assert err <= bound, (err, bound)


def _nhwc(a):
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


@pytest.fixture(scope="module")
def image_outputs():
    """{name: (port f32 out, port bf16 out, JAX bf16 out)}, each (logits, taps)."""
    x = np.random.RandomState(0).rand(4, 3, HW, HW).astype(np.float32)
    jmods, params, ported = {}, {}, {}
    for seed, (name, (depths, truncate)) in enumerate(IMAGE.items()):
        f32, taps = build_image_model(name, depths, tiny=True, truncate=truncate, input_hw=HW)
        params[name] = {"params": convert.to_jax_params(
            random_init_(f32, torch.Generator().manual_seed(seed)))}
        bf16, _ = build_image_model(name, depths, tiny=True, truncate=truncate, input_hw=HW,
                                    dtype=BF16)
        convert.from_jax_params(bf16, params[name])
        jmods[name] = jregistry.build_image_model(name, depths, tiny=True, truncate=truncate,
                                                  dtype=jnp.bfloat16)[0]
        with torch.no_grad():
            ported[name] = (f32.eval()(torch.from_numpy(x)), bf16.eval()(torch.from_numpy(x)))
    jout = jax.jit(lambda ps, xj: {n: jmods[n].apply(ps[n], xj) for n in jmods})(
        params, jnp.asarray(_nhwc(x)))
    return {n: ported[n] + (jout[n],) for n in IMAGE}


@pytest.mark.parametrize("name", list(IMAGE))
def test_image_model_bf16_matches_jax(image_outputs, name):
    (l32, t32), (l16, t16), (jl, jt) = image_outputs[name]
    assert set(t16) == set(jt) and all(t.dtype == BF16 for t in t16.values())
    assert all(v.dtype == jnp.bfloat16 for v in jt.values())
    for k in jt:
        _within_bf16(_nhwc(_np(t16[k])), jt[k], _nhwc(_np(t32[k])))
    if jl is None:
        assert l16 is None
    else:
        assert l16.dtype == torch.float32
        _within_bf16(l16, jl, l32)


def test_vit_layernorm_is_float32_on_bf16_input():
    """Flax's LayerNorm without a dtype promotes a bfloat16 input with its
    float32 parameters: the output is float32, in both packages."""
    x = np.random.RandomState(1).randn(2, 5, 8).astype(np.float32)
    xb = torch.from_numpy(x).to(BF16)
    ln = vit.LayerNorm(8, eps=vit.LN_EPS)
    with torch.no_grad():
        ln.weight.copy_(torch.linspace(0.5, 1.5, 8))
        ln.bias.copy_(torch.linspace(-0.1, 0.1, 8))
        got = ln(xb)
    want = fnn.LayerNorm().apply({"params": {"scale": ln.weight.detach().numpy(),
                                             "bias": ln.bias.detach().numpy()}},
                                 jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    block = build_image_model("vit", 1, tiny=True, input_hw=HW, dtype=BF16)[0].block0
    with torch.no_grad():
        assert block.norm1(torch.randn(2, 5, 32).to(BF16)).dtype == torch.float32


@pytest.fixture(scope="module")
def video_twins():
    """{name: (port f32 bundle, port bf16 bundle, JAX bf16 bundle)} with
    the same weights."""
    out = {}
    for seed, name in enumerate(VIDEO):
        f32 = get_video_model(name, device="cpu", tiny=True, seed=seed)
        bf16 = get_video_model(name, device="cpu", tiny=True, seed=seed, dtype=BF16)
        params = {"params": convert.to_jax_params(f32.module)}
        jb = JVideoModel(name, jvideo_zoo.TINY_BUILDERS[name](dtype=jnp.bfloat16), params)
        out[name] = (f32, bf16, jb)
    return out


@pytest.fixture(scope="module")
def video_outputs(video_twins):
    x = np.random.RandomState(2).rand(2, 3, 8, HW, HW).astype(np.float32)
    jout = jax.jit(lambda ps, xj: {n: video_twins[n][2].module.apply(ps[n], xj)
                                   for n in video_twins})(
        {n: v[2].params for n, v in video_twins.items()}, jnp.asarray(x))
    out = {}
    with torch.no_grad():
        for n, (f32, bf16, _) in video_twins.items():
            out[n] = (f32.module(torch.from_numpy(x)), bf16.module(torch.from_numpy(x)), jout[n])
    return out


@pytest.mark.parametrize("name", VIDEO)
def test_video_model_bf16_matches_jax(video_outputs, name):
    """Logits and every tap; I3D's taps run through its non-local block."""
    (l32, t32), (l16, t16), (jl, jt) = video_outputs[name]
    assert l16.dtype == torch.float32 and set(t16) == set(jt)
    _within_bf16(l16, jl, l32)
    for k in jt:
        assert t16[k].dtype == BF16 and jt[k].dtype == jnp.bfloat16
        # the port's taps are NCDHW, JAX's channel-last
        _within_bf16(_np(t16[k]).transpose(0, 2, 3, 4, 1), jt[k],
                     _np(t32[k]).transpose(0, 2, 3, 4, 1))


@pytest.mark.parametrize("nl_type", ["gaussian", "dot"])
def test_nonlocal_block_bf16_matches_jax(nl_type):
    """θφᵀ and its softmax in float32, the weights cast to g's dtype, the
    second product accumulated in float32 and cast back (JAX
    video_common.py:121-143)."""
    from i2v_tpu.models.video_common import NonLocal3D as JNonLocal3D
    from i2v_tpu_torch.models.video_common import NonLocal3D

    c = 16
    f32 = NonLocal3D(c, nl_type=nl_type)
    random_init_(f32, torch.Generator().manual_seed(3))
    params = {"params": convert.to_jax_params(f32)}
    bf16 = convert.from_jax_params(NonLocal3D(c, nl_type=nl_type).to(BF16), params)
    x = np.random.RandomState(4).randn(2, c, 2, 4, 4).astype(np.float32)
    with torch.no_grad():
        got = bf16(torch.from_numpy(x).to(BF16))
        ref = f32(torch.from_numpy(x))
    want = jax.jit(JNonLocal3D(c, nl_type=nl_type, dtype=jnp.bfloat16).apply)(
        params, jnp.asarray(x.transpose(0, 2, 3, 4, 1), jnp.bfloat16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_bf16(_np(got).transpose(0, 2, 3, 4, 1), want, _np(ref).transpose(0, 2, 3, 4, 1))


# -- cli.evaluate --bf16 ------------------------------------------------------------------

def test_evaluate_bf16_reports_match_the_jax_cli(video_twins, tmp_path, monkeypatch):
    for flag in ("cudnn.allow_tf32", "cuda.matmul.allow_tf32",
                 "cuda.matmul.allow_bf16_reduced_precision_reduction"):
        owner, attr = flag.rsplit(".", 1)
        obj = torch.backends.cudnn if owner == "cudnn" else torch.backends.cuda.matmul
        monkeypatch.setattr(obj, attr, getattr(obj, attr))
    rng = np.random.RandomState(5)
    clips = rng.randn(10, 3, 8, HW, HW).astype(np.float32)
    with torch.no_grad():
        logits = {n: _np(video_twins[n][1].apply_norm(torch.from_numpy(clips)))
                  for n in EVAL_MODELS}
    top2 = {n: np.sort(lg, axis=1)[:, -2:] for n, lg in logits.items()}
    keep = [i for i in range(len(clips))
            if all(t[i, 1] - t[i, 0] > MARGIN for t in top2.values())]
    assert len(keep) >= 4, keep
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, pdir):
        d.mkdir()
        for label in keep:
            np.save(d / f"{label}-adv.npy", clips[label])
    want = jtransfer.evaluate_run(str(jdir), model_names=list(EVAL_MODELS), batch_size=2,
                                  n_classes=10, dtype=jnp.bfloat16,
                                  get_bundle=lambda n: video_twins[n][2], log=lambda *_: None)
    args = evaluate.arg_parse(["--adv_path", str(pdir), "--bf16", "--device", "cpu",
                               "--batch_size", "2", "--n_classes", "10", "--models", *EVAL_MODELS])
    got = evaluate.run(args, get_bundle=lambda n: video_twins[n][1])
    assert (pdir / CSV).read_bytes() == (jdir / CSV).read_bytes()
    pjson, jjson = json.loads((pdir / JSON).read_text()), json.loads((jdir / JSON).read_text())
    assert list(pjson) == list(jjson) == list(EVAL_MODELS)
    for n in EVAL_MODELS:
        assert abs(pjson[n] - jjson[n]) <= 1e-6 and abs(got[n] - want[n]) <= 1e-6
    # a float32 model is not evaluated as bfloat16
    with pytest.raises(ValueError, match="computes in torch.float32"):
        evaluate.run(args, get_bundle=lambda n: video_twins[n][0])


def test_evaluate_ucf101_bf16_writes_the_101_row_reports(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction",
                        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    for label in (3, 100):
        np.save(tmp_path / f"{label}-adv.npy",
                np.random.RandomState(label).randn(3, 8, HW, HW).astype(np.float32))
    acc = evaluate_ucf101.main(["--adv_path", str(tmp_path), "--tiny", "--device", "cpu",
                                "--bf16", "--models", "tpn_resnet50"])
    rows = (tmp_path / CSV).read_text().splitlines()
    assert list(acc) == ["tpn_resnet50"] and len(rows) == 102
    assert rows[4].startswith("3,") and rows[4] != "3,-1" and rows[2] == "1,-1"
    assert json.loads((tmp_path / JSON).read_text()) == acc


def test_a_bf16_model_on_a_card_without_bf16_is_refused(monkeypatch):
    """No fallback: the build stops before any weight is drawn."""
    monkeypatch.setattr(torch.cuda, "is_bf16_supported", lambda *a, **k: False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "a card")
    with pytest.raises(RuntimeError, match="a card does not compute in bfloat16"):
        get_video_model("i3d_resnet50", device="cuda", tiny=True, dtype=BF16)
    from i2v_tpu_torch.models import get_image_models
    with pytest.raises(RuntimeError, match="does not compute in bfloat16"):
        get_image_models(["resnet"], 2, device="cuda", tiny=True, dtype=BF16)


def test_argmax_takes_the_first_index_on_a_bf16_tie():
    """Two float32 logits that round to one bfloat16 value: float32 picks
    the larger, a bfloat16 model's logits tie and both packages take the
    first index."""
    f32 = np.array([[0.5, 1.0, 1.001, -2.0], [3.0, 1.0, 3.0, 0.0]], np.float32)
    as_bf16 = torch.from_numpy(f32).to(BF16).float()
    assert int(torch.argmax(torch.from_numpy(f32)[0])) == 2
    labels = np.array([1, 2])
    acc, preds = transfer.accuracy_and_preds(as_bf16, torch.from_numpy(labels))
    jacc, jpreds = jtransfer.accuracy_and_preds(jnp.asarray(f32, jnp.bfloat16).astype(jnp.float32),
                                                jnp.asarray(labels))
    assert preds.tolist() == np.asarray(jpreds).tolist() == [1, 0]
    assert float(acc) == float(jacc) == 50.0


# -- the runner ----------------------------------------------------------------------------

@pytest.mark.parametrize("n_frames,hw,dtypes,want", [
    (512, (224, 224), (torch.float32,), 256),
    (512, (224, 224), (BF16,), None),                  # B=16 x 32 frames whole in bf16
    (960, (224, 224), (BF16,), 512),
    (512, (224, 224), (BF16, torch.float32), 256),     # a mixed ensemble budgets as f32
    (512, (112, 112), (BF16,), None),
    (4096, (112, 112), (BF16,), 2048),                 # multigrid's coarse phase
])
def test_auto_chunk_resolves_by_the_ensembles_compute_dtype(n_frames, hw, dtypes, want):
    models = [ImageModel(f"m{i}", torch.nn.Linear(1, 1).to(d)) for i, d in enumerate(dtypes)]
    for m, d in zip(models, dtypes):
        m.module.dtype = d
    dt = sharded.compute_dtype_of(models)
    assert dt == (torch.float32 if torch.float32 in dtypes else BF16)
    assert sharded.resolve_frame_chunk("auto", n_frames, hw, dt) == want


def _surrogates(dtype, names=("resnet", "squeezenet")):
    """Tiny port surrogates in ``dtype`` and JAX twins in ``dtype``, one
    weight draw."""
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    jb, pb = [], []
    for seed, name in enumerate(names):
        f32, taps = build_image_model(name, 2, tiny=True, input_hw=HW)
        params = {"params": convert.to_jax_params(
            random_init_(f32, torch.Generator().manual_seed(seed)))}
        module = convert.from_jax_params(
            build_image_model(name, 2, tiny=True, input_hw=HW, dtype=dtype)[0], params)
        pb.append(ImageModel(name, module.eval().requires_grad_(False), taps))
        jm, jtaps = jregistry.build_image_model(name, 2, tiny=True, dtype=jdt)
        jb.append(JImageModel(name, jm, params, jtaps))
    return jb, pb


def _clip(seed, b=1, t=4):
    return np.random.RandomState(seed).rand(b, 3, t, HW, HW).astype(np.float32)


def test_bf16_ensemble_runner_matches_jax():
    """Four frames of one clip through a bfloat16 surrogate with bfloat16
    storage, 3 steps: the costs; the adversarial clip in the ε-ball."""
    jb, pb = _surrogates(BF16, names=("resnet",))
    clean = _clip(6)
    _, jcosts = jsharded.make_sharded_i2v_runner(
        jb, attack_mesh(jax.devices()[:1]), steps=3, param_dtype=jnp.bfloat16)(jnp.asarray(clean))
    adv, costs = sharded.make_sharded_i2v_runner(pb, steps=3, param_dtype=BF16)(
        torch.from_numpy(clean))
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=2e-4)
    assert costs[2] < costs[0]
    assert adv.dtype == torch.float32 and float((adv - torch.from_numpy(clean)).abs().max()) \
        <= EPS + 1e-6


def test_multigrid_runs_a_bf16_ensemble_with_shared_storage():
    pb = _surrogates(BF16, names=("resnet",))[1]
    clean = torch.from_numpy(np.random.RandomState(7).rand(1, 3, 2, 64, 64).astype(np.float32))
    adv, costs = make_multigrid_i2v_runner(pb, steps=3, coarse_steps=1, frame_chunk="auto",
                                           param_dtype=BF16)(clean)
    assert costs.shape == (3,) and torch.isfinite(costs).all()
    assert float((adv - clean).abs().max()) <= EPS + 1e-6 and adv.min() >= 0 and adv.max() <= 1


def test_mu_dtype_optimizer_is_optax_adam_with_a_bf16_first_moment():
    rng = np.random.RandomState(8)
    grads = [(rng.randn(512) * 10.0 ** rng.uniform(-6, 0, 512)).astype(np.float32)
             for _ in range(3)]
    p0 = np.full(512, 0.01 / 255, np.float32)
    opt = optax.adam(0.005, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=jnp.bfloat16)
    p, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    for g in grads:
        u, st = opt.update(jnp.asarray(g), st)
        p = p + u
    tp = torch.from_numpy(p0.copy())
    adam = sharded._AdamMu(tp, 0.005, BF16, None)
    for g in grads:
        tp.grad = torch.from_numpy(g)
        adam.step()
    count, mu, nu = adam.io_state()
    assert int(count) == int(st[0].count) == 3 and mu.dtype == BF16
    np.testing.assert_array_equal(_np(mu), np.asarray(st[0].mu, np.float32))
    np.testing.assert_allclose(nu.numpy(), np.asarray(st[0].nu), rtol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(p), rtol=0, atol=1e-8)


def test_mu_dtype_runner_matches_jax_and_resumes_through_the_jax_layout():
    jb, pb = _surrogates(torch.float32, names=("resnet",))
    clean = _clip(9)
    _, jcosts, _, (jcount, jmu, _) = jsharded.make_sharded_i2v_runner(
        jb, attack_mesh(jax.devices()[:1]), steps=3, mu_dtype=jnp.bfloat16,
        opt_state_io=True, return_modifier=True)(jnp.asarray(clean))
    run = lambda steps: sharded.make_sharded_i2v_runner(  # noqa: E731
        pb, steps=steps, mu_dtype=BF16, opt_state_io=True, return_modifier=True)
    adv, costs, mod, (count, mu, nu) = run(3)(torch.from_numpy(clean))
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-5)
    assert int(count) == int(jcount) == 3 and mu.dtype == BF16 and jmu.dtype == jnp.bfloat16
    # two steps, the state out through the JAX layout (float32 arrays holding
    # the bf16 moment) and back, one more step: the three-step run, bit for bit
    _, c2, mod2, st2 = run(2)(torch.from_numpy(clean))
    jstate = convert.adam_state_to_jax(*st2)
    assert jstate[1].dtype == np.float32 and np.array_equal(
        jstate[1], np.asarray(jnp.asarray(jstate[1], jnp.bfloat16), np.float32))
    adv3, c3, mod3, (count3, mu3, nu3) = run(1)(
        torch.from_numpy(clean), mod_init=mod2, opt_init=convert.adam_state_from_jax(*jstate))
    assert torch.equal(torch.cat([c2, c3]), costs) and torch.equal(mod3, mod)
    assert int(count3) == 3 and torch.equal(mu3, mu) and torch.equal(nu3, nu)
    assert torch.equal(adv3, adv)
