"""The port's kernels (the rebuild_adv pair and the sign step) against the
JAX package.

The port's plain versions (the CPU path, and the oracles of the CUDA
kernels) are held against the JAX package's Pallas kernel bodies, run in
interpret mode on the CPU exactly as ``i2v_tpu/ops/pallas_kernels.py`` builds
the calls (atol 0, ties and NaNs included), and against ``i2v_tpu.ops.pixel``'s
plain versions (rebuild forward and sign step atol 0; rebuild gradient atol 0
away from ties, where ``jnp.clip`` splits the gradient and torch.clamp and
the Pallas VJP pass it whole). The CUDA kernels themselves run only on a
card: those tests carry the ``gpu`` marker and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from i2v_tpu.ops import pallas_kernels as pk  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu_torch.ops import kernels, pixel  # noqa: E402

EPS = 16 / 255
EPS32 = float(np.float32(EPS))
ROWS, BLOCK_ROWS = 64, 16


def _pallas(kernel, arrs, scalars=(EPS32,)):
    """The Pallas kernel, called as ``_rebuild_call`` and
    ``_sign_step_pallas`` call it, in interpret mode."""
    spec = pl.BlockSpec((BLOCK_ROWS, 128), lambda i, s: (i, 0), memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(arrs[0].shape, jnp.float32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(ROWS // BLOCK_ROWS,),
            in_specs=[spec] * len(arrs), out_specs=spec),
        interpret=True)
    return np.asarray(call(jnp.asarray(scalars, jnp.float32), *map(jnp.asarray, arrs)))


def _inputs(seed, ties=True):
    rng = np.random.RandomState(seed)
    clean = rng.rand(ROWS, 128).astype(np.float32)
    mod = ((rng.rand(ROWS, 128) * 4 - 2) * EPS).astype(np.float32)
    g = rng.randn(ROWS, 128).astype(np.float32)
    if ties:
        c, m = clean.reshape(-1), mod.reshape(-1)
        plants = [(EPS32, None), (-EPS32, None), (-EPS32, EPS32), (0.0, 1.0), (0.0, 0.0),
                  (-0.0, 0.5), (EPS32, 1.0 - EPS32), (np.nan, 0.5), (0.01, np.nan)]
        for k, (mv, cv) in enumerate(plants):
            i = 97 * k + 5
            m[i] = mv
            if cv is not None:
                c[i] = cv
    return clean, mod, g


def _port(clean, mod, g, fn=pixel.rebuild_adv):
    m = torch.from_numpy(mod).requires_grad_(True)
    out = fn(torch.from_numpy(clean), m, EPS32)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), m.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_interpret_pallas_with_ties(seed):
    clean, mod, g = _inputs(seed)
    out, dm = _port(clean, mod, g)
    np.testing.assert_array_equal(out, _pallas(pk._rebuild_fwd_kernel, (clean, mod)))
    np.testing.assert_array_equal(dm, _pallas(pk._rebuild_bwd_kernel, (clean, mod, g)))
    # the planted ties really are ties
    u = clean + np.clip(mod, -EPS32, EPS32)
    assert (np.abs(mod) == EPS32).sum() >= 3 and (u == 0).any() and (u == 1).any()


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    kernels.reset_launches()
    clean, mod, g = _inputs(2)
    np.testing.assert_array_equal(
        np.stack(_port(clean, mod, g, kernels.rebuild_adv)), np.stack(_port(clean, mod, g)))
    # an unrounded ε lands on the same ties: the wrapper rounds it to f32
    out = kernels.rebuild_adv(torch.from_numpy(clean), torch.from_numpy(mod), EPS)
    np.testing.assert_array_equal(out.numpy(), _port(clean, mod, g)[0])
    assert kernels.launches == {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": 0, "bias_act": 0,
                                "window_attn": 0, "pool_attn": 0, "pool_qkv": 0, "dwconv3d": 0,
                                "global_attn": 0}


def test_forward_matches_jax_pixel_with_ties():
    clean, mod, _ = _inputs(3)
    want = np.asarray(jpixel.rebuild_adv(jnp.asarray(clean), jnp.asarray(mod), EPS32))
    got = pixel.rebuild_adv(torch.from_numpy(clean), torch.from_numpy(mod), EPS32).numpy()
    np.testing.assert_array_equal(got, want)


def test_gradient_matches_jax_pixel_away_from_ties():
    clean, mod, g = _inputs(4, ties=False)
    u = clean + np.clip(mod, -EPS32, EPS32)
    assert not (np.abs(mod) == EPS32).any() and not ((u == 0) | (u == 1)).any()
    want = np.asarray(jax.grad(
        lambda m: jnp.sum(jnp.asarray(g) * jpixel.rebuild_adv(jnp.asarray(clean), m, EPS32))
    )(jnp.asarray(mod)))
    _, got = _port(clean, mod, g)
    np.testing.assert_array_equal(got, want)


def test_gradcheck_away_from_kinks():
    rng = np.random.RandomState(5)
    n = 64
    clean = torch.from_numpy(0.2 + 0.6 * rng.rand(n))
    # |m| well inside ε or well outside it; u stays inside (0, 1)
    mag = np.where(rng.rand(n) < 0.5, 0.5 * EPS * rng.rand(n), (1.5 + rng.rand(n)) * EPS)
    mod = torch.from_numpy(mag * np.sign(rng.randn(n))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda m: kernels.rebuild_adv(clean, m, EPS), (mod,))


def test_frame_flatten_hands_the_kernel_a_contiguous_modifier():
    clip = torch.from_numpy(np.random.RandomState(6).rand(2, 3, 4, 8, 8).astype(np.float32))
    frames = pixel.flatten_clip_to_frames(clip)
    assert frames.is_contiguous() and frames.shape == (8, 3, 8, 8)
    assert torch.full_like(frames, 0.1).is_contiguous()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _cuda_inputs(n, seed, device):
    clean, mod, g = (torch.from_numpy(a.reshape(-1)[:n].copy()).to(device)
                     for a in _inputs(seed))
    return clean, mod, g


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 4097, ROWS * 128])
def test_kernel_matches_plain_on_card(cuda, n):
    clean, mod, g = _cuda_inputs(n, 7, cuda)
    kernels.reset_launches()
    m = mod.clone().requires_grad_(True)
    out = kernels.rebuild_adv(clean, m, EPS)
    out.backward(g)
    assert kernels.launches == {"rebuild_fwd": 1, "rebuild_bwd": 1, "sign_step": 0, "bias_act": 0,
                                "window_attn": 0, "pool_attn": 0, "pool_qkv": 0, "dwconv3d": 0,
                                "global_attn": 0}
    m_ref = mod.clone().requires_grad_(True)
    ref = pixel.rebuild_adv(clean, m_ref, EPS32)
    ref.backward(g)
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(m.grad, m_ref.grad, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    clean, mod, _ = _cuda_inputs(ROWS * 128, 8, cuda)
    with pytest.raises(TypeError):
        kernels.rebuild_adv(clean.double(), mod.double(), EPS)
    with pytest.raises(ValueError):
        kernels.rebuild_adv(clean.view(ROWS, 128).t(), mod.view(ROWS, 128).t(), EPS)
    with pytest.raises(ValueError):
        kernels.rebuild_adv(clean.cpu(), mod, EPS)
    with pytest.raises(ValueError):
        kernels.rebuild_adv(clean[1:], mod[:-1].view(-1, 1), EPS)


# -- K3: the sign step ------------------------------------------------------

ALPHA32 = float(np.float32(EPS / 10))  # BIM's step at 10 steps


def _sign_inputs(seed, plants=True):
    """(adv, g, clean) as (ROWS, 128) float32: adv within ±ε of clean, with
    ties at ±ε and at 0 and 1 exactly, ±0 and NaN gradients and NaN pixels
    planted."""
    rng = np.random.RandomState(seed)
    clean = rng.rand(ROWS, 128).astype(np.float32)
    adv = np.clip(clean + (rng.rand(ROWS, 128) * 2 - 1) * EPS, 0, 1).astype(np.float32)
    g = rng.randn(ROWS, 128).astype(np.float32)
    if plants:
        a, gg, c = adv.reshape(-1), g.reshape(-1), clean.reshape(-1)
        step_to_eps = np.float32(EPS32 - ALPHA32)
        while np.float32(step_to_eps + np.float32(ALPHA32)) != np.float32(EPS32):
            step_to_eps = np.nextafter(step_to_eps, np.float32(1))
        plants = [(EPS32, 0.0, 0.0), (step_to_eps, 1.0, 0.0), (-EPS32, 0.0, 0.0),
                  (0.0, -1.0, 0.0), (1.0, 1.0, 1.0), (1.0, 0.0, 1.0), (0.5, -0.0, 0.5),
                  (0.5, 0.0, 0.5), (0.5, np.nan, 0.5), (np.nan, 1.0, 0.5), (0.5, 1.0, np.nan)]
        for k, (av, gv, cv) in enumerate(plants):
            i = 89 * k + 3
            a[i], gg[i], c[i] = av, gv, cv
    return adv, g, clean


def _sign_plain(adv, g, clean, alpha=ALPHA32, eps=EPS32, fn=pixel.sign_step_project):
    return fn(torch.from_numpy(adv), torch.from_numpy(g), torch.from_numpy(clean),
              alpha, eps).numpy()


def test_sign_step_nan_gradient_gives_nan_in_all_three_versions():
    """The plain version carries a NaN gradient to a NaN pixel, as
    ``jnp.sign`` and the Pallas kernel do; ±0 gradients leave the pixel."""
    adv, g, clean = _sign_inputs(9, plants=False)
    adv.reshape(-1)[:5] = clean.reshape(-1)[:5] = 0.5
    g.reshape(-1)[:5] = [np.nan, -0.0, 0.0, 1.0, -1.0]
    alpha = float(np.float32(0.01))
    got = _sign_plain(adv, g, clean, alpha)
    want_jnp = np.asarray(jpixel.sign_step_project(
        jnp.asarray(adv), jnp.asarray(g), jnp.asarray(clean), alpha, EPS32))
    want_pallas = _pallas(pk._sign_step_kernel, (adv, g, clean), (alpha, EPS32))
    np.testing.assert_array_equal(got.reshape(-1)[:5],
                                  np.float32([np.nan, 0.5, 0.5, 0.5 + alpha, 0.5 - alpha]))
    np.testing.assert_array_equal(got, want_jnp)
    np.testing.assert_array_equal(got, want_pallas)


@pytest.mark.parametrize("seed", [0, 1])
def test_sign_step_plain_matches_interpret_pallas_with_ties_and_nans(seed):
    adv, g, clean = _sign_inputs(seed)
    got = _sign_plain(adv, g, clean)
    np.testing.assert_array_equal(
        got, _pallas(pk._sign_step_kernel, (adv, g, clean), (ALPHA32, EPS32)))
    # the planted ties really are ties, and the NaNs surface
    delta = (adv + ALPHA32 * np.sign(g)).astype(np.float32) - clean
    assert (delta == EPS32).sum() >= 2 and (delta == -EPS32).any()
    assert (got == 0).any() and (got == 1).any() and np.isnan(got).sum() == 3


def test_sign_step_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    kernels.reset_launches()
    adv, g, clean = _sign_inputs(2)
    # unrounded α and ε land on the same ties: the wrapper rounds both to f32
    got = _sign_plain(adv, g, clean, EPS / 10, EPS, fn=kernels.sign_step_project)
    np.testing.assert_array_equal(got, _sign_plain(adv, g, clean))
    np.testing.assert_array_equal(got, np.asarray(pk.sign_step_project(
        jnp.asarray(adv), jnp.asarray(g), jnp.asarray(clean), EPS / 10, EPS)))
    assert kernels.launches == {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": 0, "bias_act": 0,
                                "window_attn": 0, "pool_attn": 0, "pool_qkv": 0, "dwconv3d": 0,
                                "global_attn": 0}


def test_sign_step_wrapper_passes_no_gradient():
    adv, g, clean = (torch.from_numpy(a) for a in _sign_inputs(3, plants=False))
    out = kernels.sign_step_project(adv.requires_grad_(True), g, clean, ALPHA32, EPS32)
    assert not out.requires_grad


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 4097, ROWS * 128])
@pytest.mark.parametrize("offset", [0, 1])
def test_sign_step_kernel_matches_plain_on_card(cuda, n, offset):
    adv, g, clean = (torch.from_numpy(a.reshape(-1)).to(cuda)[offset:offset + n]
                     for a in _sign_inputs(10))
    kernels.reset_launches()
    out = kernels.sign_step_project(adv, g, clean, EPS / 10, EPS)
    assert kernels.launches["sign_step"] == 1
    ref = pixel.sign_step_project(adv, g, clean, ALPHA32, EPS32)
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_sign_step_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    adv, g, clean = (torch.from_numpy(a).to(cuda) for a in _sign_inputs(11))
    with pytest.raises(TypeError):
        kernels.sign_step_project(adv.double(), g.double(), clean.double(), ALPHA32, EPS32)
    with pytest.raises(ValueError):
        kernels.sign_step_project(adv.t(), g.t(), clean.t(), ALPHA32, EPS32)
    with pytest.raises(ValueError):
        kernels.sign_step_project(adv, g.cpu(), clean, ALPHA32, EPS32)
    with pytest.raises(ValueError):
        kernels.sign_step_project(adv, g[1:], clean, ALPHA32, EPS32)


def test_launch_counts_are_exact_under_concurrent_increments():
    """The mesh runners launch K2 from the autograd engine's thread of each
    card: every increment of the launch counts must land. Eight threads add
    20,000 each under a short switch interval, which loses updates to an
    unlocked ``+=``."""
    import sys
    import threading

    saved = dict(kernels.launches)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.reset_launches()
        threads = [threading.Thread(target=lambda: [kernels.count_launch("rebuild_bwd")
                                                    for _ in range(20_000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert kernels.launches == {"rebuild_fwd": 0, "rebuild_bwd": 160_000, "sign_step": 0,
                                    "bias_act": 0, "window_attn": 0, "pool_attn": 0, "pool_qkv": 0,
                                    "dwconv3d": 0, "global_attn": 0}
    finally:
        sys.setswitchinterval(interval)
        kernels.launches.update(saved)
