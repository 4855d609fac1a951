"""The rebuild_adv kernel pair of the PyTorch port against the JAX package.

The port's plain version (the CPU path, and the oracle of the CUDA kernels)
is held against the JAX package's Pallas kernel bodies, run in interpret
mode on the CPU exactly as ``i2v_tpu/ops/pallas_kernels.py`` builds the call
(atol 0, ties and NaNs included), and against ``i2v_tpu.ops.pixel``'s plain
rebuild (forward atol 0; gradient atol 0 away from ties, where ``jnp.clip``
splits the gradient and torch.clamp and the Pallas VJP pass it whole). The
CUDA kernels themselves run only on a card: those tests carry the ``gpu``
marker and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from i2v_tpu.ops import pallas_kernels as pk  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu_torch.ops import kernels, pixel  # noqa: E402

EPS = 16 / 255
EPS32 = float(np.float32(EPS))
ROWS, BLOCK_ROWS = 64, 16


def _pallas(kernel, arrs):
    """The Pallas kernel, called as ``_rebuild_call`` calls it, in interpret
    mode."""
    spec = pl.BlockSpec((BLOCK_ROWS, 128), lambda i, s: (i, 0), memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(arrs[0].shape, jnp.float32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(ROWS // BLOCK_ROWS,),
            in_specs=[spec] * len(arrs), out_specs=spec),
        interpret=True)
    return np.asarray(call(jnp.asarray([EPS32], jnp.float32), *map(jnp.asarray, arrs)))


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
    assert kernels.launches == {"rebuild_fwd": 0, "rebuild_bwd": 0}


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
    assert kernels.launches == {"rebuild_fwd": 1, "rebuild_bwd": 1}
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
