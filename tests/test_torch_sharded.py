"""The port's frame-chunked runner (``i2v_tpu_torch.parallel.sharded``)
against the JAX package's ``make_sharded_i2v_runner`` on a 1-device mesh,
and against itself.

The same weights (JAX → port through ``from_jax_params``) and the same numpy
clips (2 × 8 frames at 32², tiny surrogates) go through both packages.
Tolerances:
  - costs, port vs JAX: rtol 1e-5 over the steps compared. AENS's costs
    also hold atol 1e-5: its coefficients are a softmax of the previous
    step's per-tap sums and so follow any divergence with a gain (three
    steps, as in tests/test_torch_image_guided.py);
  - gradients at a generic modifier, away from the clamp ties where the JAX
    CPU rebuild halves a gradient: atol 1e-5 of max|g|;
  - chunked against unchunked in the port: the step-0 gradient within 1e-6
    of max|g|, rtol 1e-5 on the costs, and atol 2e-6 on the clips
    (tests/test_parallel.py holds the JAX runner so) for all but 0.1% of
    the pixels;
  - chained segments, pad clips and remat: bit for bit on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.models import get_image_models as jget_image_models  # noqa: E402
from i2v_tpu.ops import losses as jlosses  # noqa: E402
from i2v_tpu.ops import pallas_kernels as pk  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu.parallel import attack_mesh, shard_clips  # noqa: E402
from i2v_tpu.parallel import sharded as jsharded  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.data.transforms import u8_clip_to_normalized  # noqa: E402
from i2v_tpu_torch.models import ImageModel, build_image_model  # noqa: E402
from i2v_tpu_torch.models import convert  # noqa: E402
from i2v_tpu_torch.ops import pixel  # noqa: E402
from i2v_tpu_torch.parallel import sharded  # noqa: E402

EPS = 16 / 255
HW = 32
T = 8
STEPS = 3
SEG = 4                    # steps of a resumable segment
I2V_DEPTHS = {"resnet": 2}
AENS_DEPTHS = {"resnet": [1, 2]}       # two taps, as tests/test_torch_image_guided.py


def _pair(depths):
    """Tiny JAX bundles and their port twins, sharing weights."""
    jbundles = jget_image_models(list(depths), depths, tiny=True, input_hw=HW)
    ported = []
    for b in jbundles:
        module, taps = build_image_model(b.name, depths[b.name], tiny=True, input_hw=HW)
        convert.from_jax_params(module, jax.tree_util.tree_map(np.asarray, b.params))
        ported.append(ImageModel(b.name, module.eval().requires_grad_(False), taps))
    return jbundles, ported


def _clips(seed, b=2):
    return np.random.RandomState(seed).rand(b, 3, T, HW, HW).astype(np.float32)


def _generic_modifier(seed, n):
    """A modifier strictly inside ±ε, in the port's (N, 3, H, W) layout."""
    return ((np.random.RandomState(seed).rand(n, 3, HW, HW) * 2 - 1) * 0.9 * EPS).astype(np.float32)


def _jax_runner(jb, **kw):
    return jsharded.make_sharded_i2v_runner(jb, attack_mesh(jax.devices()[:1]), **kw)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_invariants(adv01, clean01):
    a = _np(adv01)
    assert a.shape == clean01.shape and np.isfinite(a).all()
    assert a.min() >= 0 and a.max() <= 1
    assert np.abs(a - clean01).max() <= np.float32(EPS) + 1e-6


@pytest.fixture(scope="module")
def i2v_pair():
    return _pair(I2V_DEPTHS)


@pytest.fixture(scope="module")
def aens_pair():
    return _pair(AENS_DEPTHS)


@pytest.fixture(scope="module")
def jax_segments(i2v_pair):
    """The JAX I2V runner at chunk 4 as a resumable 4-step segment, called
    twice in a chain on the clips of seed 0: by tests/test_chained_opt.py,
    the two calls are the JAX 8-step trajectory."""
    seg = _jax_runner(i2v_pair[0], steps=SEG, frame_chunk=4, return_modifier=True,
                      opt_state_io=True)
    clean = _clips(0)
    first = seg(shard_clips(jnp.asarray(clean), attack_mesh(jax.devices()[:1])))
    second = seg(jnp.asarray(clean), mod_init=first[2], opt_init=first[3])
    return clean, [jax.tree_util.tree_map(np.asarray, o) for o in (first, second)]


# -- port against the JAX runner -----------------------------------------------

def test_i2v_runner_matches_jax(i2v_pair, jax_segments):
    clean, (first, _) = jax_segments
    runner = sharded.make_sharded_i2v_runner(i2v_pair[1], steps=SEG, frame_chunk=4)
    adv, costs = runner(torch.from_numpy(clean))
    np.testing.assert_allclose(_np(costs), first[1], rtol=1e-5)
    _check_invariants(adv, clean)
    assert _np(costs)[-1] < _np(costs)[0]


@pytest.mark.parametrize("kw", [
    {"aens_momentum": 0.5, "frame_chunk": 8},
    {"coef_ce": True},
], ids=["momentum0.5-chunk8", "coef_ce-unchunked"])
def test_aens_runner_matches_jax(aens_pair, kw):
    jb, pb = aens_pair
    clean = _clips(1)
    jrunner = _jax_runner(jb, steps=STEPS, adaptive=True, **kw)
    runner = sharded.make_sharded_i2v_runner(pb, steps=STEPS, adaptive=True, **kw)
    jcosts = [np.asarray(jrunner(jnp.asarray(c))[1]) for c in (clean, _clips(2))]
    costs = [_np(runner(torch.from_numpy(c))[1]) for c in (clean, _clips(2))]
    # the second call starts from the coefficients the first left behind
    for got, want in zip(costs, jcosts):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["i2v", "aens"])
def test_chunked_gradient_matches_jax_at_a_generic_modifier(i2v_pair, aens_pair, method):
    jb, pb = i2v_pair if method == "i2v" else aens_pair
    adaptive = method == "aens"
    clean = (0.1 + 0.8 * _clips(3)).astype(np.float32)
    mod = _generic_modifier(4, clean.shape[0] * T)
    frames = jpixel.flatten_clip_to_frames(jnp.asarray(clean))
    clean_taps = [jax.lax.stop_gradient(t) for b in jb for t in b.apply01_taps(frames)[1]]

    def jcost(m):
        taps = [t for b in jb for t in b.apply01_taps(pk.rebuild_adv(frames, m, EPS))[1]]
        if adaptive:  # the first step's coefficients: prev = 1, coeffs = 1
            n = len(taps)
            coeffs = jax.nn.softmax(jax.nn.softmax(jnp.ones(n)) + 0.5 * jnp.ones(n))
            per_tap = jlosses.per_tap_frame_cosines(taps, clean_taps)
            return jnp.mean(jnp.sum(coeffs[:, None] * per_tap, axis=1))
        return jlosses.i2v_cost(taps, clean_taps)

    want_c, want_g = jax.jit(jax.value_and_grad(jcost))(jnp.asarray(convert.modifier_to_jax(
        torch.from_numpy(mod))))
    runner = sharded.make_sharded_i2v_runner(pb, steps=1, adaptive=adaptive, aens_momentum=0.5,
                                             frame_chunk=4)
    cost, g = runner.value_and_grad(torch.from_numpy(clean), torch.from_numpy(mod))
    want_g = np.asarray(want_g)
    assert np.abs(want_g).max() > 0
    np.testing.assert_allclose(float(cost), float(want_c), rtol=1e-5)
    np.testing.assert_allclose(convert.modifier_to_jax(g), want_g,
                               atol=1e-5 * np.abs(want_g).max())


def test_bf16_param_storage_matches_jax(i2v_pair):
    jb, pb = i2v_pair
    clean = _clips(5)
    want = np.asarray(_jax_runner(jb, steps=STEPS, frame_chunk=4,
                                  param_dtype=jnp.bfloat16)(jnp.asarray(clean))[1])
    cast = sharded.cast_param_storage(pb, torch.bfloat16)
    stored = [p for m in cast for p in m.module.parameters()]
    assert stored and all(p.dtype == torch.bfloat16 for p in stored)
    assert all(p.dtype == torch.float32 for m in pb for p in m.module.parameters())
    with torch.no_grad():
        taps = cast[0].apply01_taps(torch.from_numpy(clean[0].transpose(1, 0, 2, 3)))[1]
    assert all(t.dtype == torch.float32 for t in taps)   # the convs stay float32
    runner = sharded.make_sharded_i2v_runner(pb, steps=STEPS, frame_chunk=4,
                                             param_dtype=torch.bfloat16)
    costs = _np(runner(torch.from_numpy(clean))[1])
    np.testing.assert_allclose(costs, want, rtol=1e-5)
    f32 = _np(sharded.make_sharded_i2v_runner(pb, steps=STEPS, frame_chunk=4)(
        torch.from_numpy(clean))[1])
    assert not np.array_equal(costs, f32)   # the rounding does show


# -- runner state across the packages --------------------------------------------

def test_runner_state_round_trip_jax_port_jax(jax_segments):
    _, (first, _) = jax_segments
    mod, (count, mu, nu) = first[2], first[3]
    port_mod = convert.modifier_from_jax(mod)
    step, exp_avg, exp_avg_sq = convert.adam_state_from_jax(count, mu, nu)
    assert port_mod.shape == (mod.shape[0], 3, HW, HW)
    assert step.dtype == torch.float32 and float(step) == SEG
    np.testing.assert_array_equal(convert.modifier_to_jax(port_mod), mod)
    back = convert.adam_state_to_jax(step, exp_avg, exp_avg_sq)
    assert back[0].dtype == np.int32 and back[0] == count
    np.testing.assert_array_equal(back[1], mu)
    np.testing.assert_array_equal(back[2], nu)


def test_a_jax_segment_continues_in_the_port(i2v_pair, jax_segments):
    clean, (first, second) = jax_segments
    seg = sharded.make_sharded_i2v_runner(i2v_pair[1], steps=SEG, frame_chunk=4,
                                          return_modifier=True, opt_state_io=True)
    adv, costs, mod, (step, _, _) = seg(
        torch.from_numpy(clean), mod_init=convert.modifier_from_jax(first[2]),
        opt_init=convert.adam_state_from_jax(*first[3]))
    np.testing.assert_allclose(_np(costs), second[1], rtol=1e-5)
    assert float(step) == 2 * SEG
    _check_invariants(adv, clean)


# -- the port against itself -------------------------------------------------------

def test_chained_segments_are_bit_identical_to_one_run(i2v_pair):
    clean = torch.from_numpy(_clips(6))
    kw = dict(frame_chunk=4, return_modifier=True, opt_state_io=True)
    adv_full, costs_full, mod_full, st_full = sharded.make_sharded_i2v_runner(
        i2v_pair[1], steps=3 * SEG, **kw)(clean)
    seg = sharded.make_sharded_i2v_runner(i2v_pair[1], steps=SEG, **kw)
    mod = st = None
    costs = []
    for _ in range(3):
        adv, c, mod, st = seg(clean, mod_init=mod, opt_init=st)
        costs.append(_np(c))
    np.testing.assert_array_equal(np.concatenate(costs), _np(costs_full))
    for got, want in [(adv, adv_full), (mod, mod_full)] + list(zip(st, st_full)):
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("method,chunk,b", [("i2v", 4, 2), ("aens", 8, 2), ("i2v", 16, 3)],
                         ids=["i2v-chunk4", "aens-chunk8", "i2v-24frames-chunk16-snaps-to-12"])
def test_chunked_equals_unchunked(i2v_pair, aens_pair, method, chunk, b):
    """The step-0 gradient within 1e-6 of max|g|, the costs within rtol
    1e-5, and the clips within 2e-6 on all but 0.1% of the pixels. A chunk's
    convs sum in another order than the whole batch's (the CPU's conv
    kernels block by batch size), and Adam's first step, g/(|g| + 1e-8),
    turns that into up to ~1e-5 at the rare pixel whose |g| is near 1e-8."""
    pb = (i2v_pair if method == "i2v" else aens_pair)[1]
    kw = dict(steps=STEPS, adaptive=method == "aens", aens_momentum=0.5)
    clean = torch.from_numpy(_clips(7, b))
    mod = torch.from_numpy(_generic_modifier(8, b * T))
    full = sharded.make_sharded_i2v_runner(pb, **kw)
    chunked = sharded.make_sharded_i2v_runner(pb, frame_chunk=chunk, **kw)
    g_f, g_c = (_np(r.value_and_grad(clean, mod)[1]) for r in (full, chunked))
    assert np.abs(g_c - g_f).max() <= 1e-6 * np.abs(g_f).max()
    adv_f, costs_f = full(clean)
    adv_c, costs_c = chunked(clean)
    np.testing.assert_allclose(_np(costs_c), _np(costs_f), rtol=1e-5)
    assert np.mean(np.abs(_np(adv_c) - _np(adv_f)) > 2e-6) <= 1e-3
    if b == 3:
        assert sharded.snap_frame_chunk(chunk, b * T) == 12
        explicit = sharded.make_sharded_i2v_runner(pb, frame_chunk=12, **kw)(clean)
        np.testing.assert_array_equal(_np(explicit[1]), _np(costs_c))


@pytest.mark.parametrize("method", ["i2v", "aens"])
def test_unchunked_runner_is_the_attack_classes_loop(i2v_pair, aens_pair, method):
    """Without chunks the runner computes what attacks/i2v.py computes."""
    pb = (i2v_pair if method == "i2v" else aens_pair)[1]
    clean = _clips(8)
    if method == "i2v":
        atk = attacks.ImageGuidedFMDirection_Adam(pb, step_size=0.005, steps=STEPS)
        runner = sharded.make_sharded_i2v_runner(pb, steps=STEPS)
    else:
        atk = attacks.AENS_I2V_MF(pb, step_size=0.005, momentum=0.5, steps=STEPS)
        runner = sharded.make_sharded_i2v_runner(pb, steps=STEPS, adaptive=True,
                                                 aens_momentum=0.5)
    want_adv, want_costs, _ = atk._run(torch.from_numpy(clean))
    if method == "aens":
        want_costs = want_costs[0]
    adv, costs = runner(torch.from_numpy(clean))
    np.testing.assert_array_equal(_np(costs), _np(want_costs))
    np.testing.assert_array_equal(_np(adv), _np(want_adv))


def test_pad_clips_are_inert_for_adaptive_aens(aens_pair):
    """``n_real=3`` on a 4-clip batch (the 4th a repeat of the 3rd) gives the
    3-clip run, bit for bit, and leaves the same coefficients for the next
    call: the pad frames are masked out of the cost, the gradients and the
    coefficient sums."""
    kw = dict(steps=STEPS, adaptive=True, aens_momentum=0.5, frame_chunk=8)
    ref = sharded.make_sharded_i2v_runner(aens_pair[1], **kw)
    pad = sharded.make_sharded_i2v_runner(aens_pair[1], **kw)
    c3 = _clips(9, 3)
    c4 = np.concatenate([c3, c3[-1:]])
    adv_r, costs_r = ref(torch.from_numpy(c3))
    adv_p, costs_p = pad(torch.from_numpy(c4), n_real=3)
    np.testing.assert_array_equal(_np(costs_p), _np(costs_r))
    np.testing.assert_array_equal(_np(adv_p)[:3], _np(adv_r))
    nxt = torch.from_numpy(_clips(10, 4))
    np.testing.assert_array_equal(_np(pad(nxt)[1]), _np(ref(nxt)[1]))


def test_remat_gives_the_same_costs(i2v_pair):
    clean = torch.from_numpy(_clips(11))
    plain = sharded.make_sharded_i2v_runner(i2v_pair[1], steps=STEPS, frame_chunk=4)(clean)
    remat = sharded.make_sharded_i2v_runner(i2v_pair[1], steps=STEPS, frame_chunk=4,
                                            remat=True)(clean)
    np.testing.assert_array_equal(_np(remat[1]), _np(plain[1]))
    np.testing.assert_array_equal(_np(remat[0]), _np(plain[0]))


# -- frame_chunk resolution ---------------------------------------------------------

@pytest.mark.parametrize("frame_chunk,n_frames,hw,want", [
    (None, 512, (224, 224), None),
    (64, 512, (224, 224), 64),
    ("auto", 512, (224, 224), 256),      # B=16 at 224²: two chunks
    ("auto", 960, (224, 224), 256),      # B=30: the runner snaps it to 240
    ("auto", 256, (224, 224), None),     # B=8 fits the budget whole
    ("auto", 32, (224, 224), None),
    ("auto", 512, (112, 112), None),     # multigrid's coarse phase at B=16: 1024 fit
    ("auto", 2048, (112, 112), 1024),
    ("auto", 64, (32, 32), None),
])
def test_resolve_frame_chunk_table(frame_chunk, n_frames, hw, want):
    assert sharded.AUTO_CHUNK_BYTES == 256 * 4 * 224 * 224
    assert sharded.resolve_frame_chunk(frame_chunk, n_frames, hw) == want


@pytest.mark.parametrize("chunk,n_frames,want", [
    (None, 24, 24), (30, 24, 24), (24, 24, 24), (16, 24, 12), (7, 24, 6), (5, 32, 4),
    (128, 512, 128), (100, 512, 64), (256, 960, 240),
])
def test_snap_frame_chunk_takes_the_largest_divisor_that_fits(chunk, n_frames, want):
    assert sharded.snap_frame_chunk(chunk, n_frames) == want


def test_bad_settings_are_refused(i2v_pair):
    pb = i2v_pair[1]
    with pytest.raises(ValueError, match="frame_chunk must be an int, None, or 'auto'"):
        sharded.resolve_frame_chunk("all", 16, (HW, HW))
    with pytest.raises(ValueError, match="frame_chunk must be an int, None, or 'auto'"):
        sharded.make_sharded_i2v_runner(pb, steps=1, frame_chunk="all")
    with pytest.raises(ValueError, match="at least 1"):
        sharded.snap_frame_chunk(0, 16)
    # mu_dtype is ported (item 10): a bfloat16 first moment is taken and
    # stored, a non-floating one refused
    with pytest.raises(ValueError, match="mu_dtype must be a floating torch dtype"):
        sharded.make_sharded_i2v_runner(pb, steps=1, mu_dtype=torch.int32)
    runner = sharded.make_sharded_i2v_runner(pb, steps=1, mu_dtype=torch.bfloat16,
                                             opt_state_io=True)
    count, mu, nu = runner(_clips(5, b=1))[2]
    assert int(count) == 1 and mu.dtype == torch.bfloat16 and nu.dtype == torch.float32


# -- the attack adapter ---------------------------------------------------------------

def test_sharded_attack_records_costs_and_returns_normalized_clips(aens_pair):
    kw = dict(steps=STEPS, step_size=0.005, adaptive=True, aens_momentum=0.5, frame_chunk=8)
    atk = sharded.ShardedImageGuidedAttack(aens_pair[1], name="AENS_I2V_MF", **kw)
    runner = sharded.make_sharded_i2v_runner(aens_pair[1], **kw)
    for seed in (12, 13):   # the coefficients persist in both
        clean = _clips(seed)
        videos = pixel.normalize(torch.from_numpy(clean), channel_axis=1).numpy()
        adv = atk(videos, [0, 1], video_names=["a", "b"])
        want_adv, want_costs = runner(pixel.unnormalize(torch.from_numpy(videos), 1))
        np.testing.assert_array_equal(_np(adv), _np(pixel.normalize(want_adv, 1)))
        recorded = [float(atk.loss_info["b"][i]["cost"]) for i in range(STEPS)]
        np.testing.assert_array_equal(np.float32(recorded), _np(want_costs))
    assert str(atk).startswith("AENS_I2V_MF(")


def test_sharded_attack_refuses_uint8_and_aens_multigrid(i2v_pair):
    """uint8 batches are no longer refused: a raw (B,T,H,W,3) batch gives the
    float32 path's output, bit for bit. AENS with --multigrid still is."""
    atk = sharded.ShardedImageGuidedAttack(i2v_pair[1], steps=1, step_size=0.005)
    u8 = np.random.RandomState(5).randint(0, 256, (1, T, HW, HW, 3), np.uint8)
    videos = np.stack([u8_clip_to_normalized(c) for c in u8])
    np.testing.assert_array_equal(_np(atk(u8)), _np(atk(videos)))
    with pytest.raises(ValueError) as port_err:
        sharded.ShardedImageGuidedAttack(i2v_pair[1], steps=4, step_size=0.005, adaptive=True,
                                         multigrid=2)
    with pytest.raises(ValueError) as jax_err:
        jsharded.ShardedImageGuidedAttack(i2v_pair[0], attack_mesh(jax.devices()[:1]), steps=4,
                                          step_size=0.005, adaptive=True, multigrid=2)
    assert str(port_err.value) == str(jax_err.value)
