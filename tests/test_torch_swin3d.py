"""Video Swin-B (``i2v_tpu_torch/models/swin3d.py``) against the benchmark's
plain reference (``port_bench/reference/swin3d.py``), its window-attention
kernel against the plain path, and its place in the registry, the
converter, the init and the evaluation.

On the CPU the port runs the plain path, and the tiny model and the
reference, filled with the same seeded weights, give the same logits and
stage taps within 1e-5 of the reference's scale (float32 accumulated in
another order would differ by ~1e-6; they run the same ops here) at shapes
that exercise padding, clipped windows and shifts, shift masks and several
windows along every axis; each planted fault below fails that comparison.
The ``gpu`` tests hold ``window_attn_fwd_kernel`` to the plain path at the
four stages' shapes, a clipped and a padded shape, windows whose N leaves
tails in the kernel's tiles and a launch of fewer window-heads than SMs, in
float32 and bfloat16;
a captured forward to its eager step 0, bit for bit; and count 24 launches
(one a block) in a full-depth forward. The file imports neither JAX nor the
JAX package, so that it runs on a machine with a card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_swin3d.py -m gpu``.
Without a card those tests skip."""

import math
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from i2v_tpu_torch.eval import transfer  # noqa: E402
from i2v_tpu_torch.models import convert, registry, swin3d, video_zoo  # noqa: E402
from i2v_tpu_torch.ops import kernels  # noqa: E402
from i2v_tpu_torch.utils import VIDEO_MODEL_NAMES  # noqa: E402
from port_bench import weights  # noqa: E402
from port_bench.entries.swin_eval import layer_norms_about_one_  # noqa: E402
from port_bench.reference import swin3d as ref_swin3d  # noqa: E402

TAPS = ("stage1", "stage2", "stage3", "stage4")
TOL = 1e-5
# tiny model: patch (2,4,4), window (4,3,3); clip (B, 3, T, H, W) → first grid
CASES = {
    # grid (5, 11, 9): T and H padded to (8, 12); 2 x 4 x 3 windows; shifted masks
    "padding": (2, 3, 10, 44, 36),
    # grid (3, 6, 6): T no larger than the window (window 3, shift 0 along T);
    # stage 3's 3 x 3 and stage 4's 2 x 2 grids clip H and W too
    "clipped": (1, 3, 6, 24, 24),
    # grid (8, 12, 12): 2 x 4 x 4 windows, then 2 x 2 x 2 with a mask on every axis
    "every_axis": (1, 3, 16, 48, 48),
}


def _pair(seed=3):
    """The tiny port model (all four taps) and the reference, same weights."""
    port = swin3d.swin3d_tiny(taps=TAPS).eval()
    ref = ref_swin3d.build(tiny=True)
    for m in (port, ref):
        layer_norms_about_one_(weights.fill_(m, seed, 0))
    return port, ref


def _clip(shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _gap(port, ref, x) -> float:
    """The largest gap of the logits and the four taps, over each one's
    reference scale (its std)."""
    with torch.no_grad():
        logits, taps = port(x, normalize=False)
        want_logits, feats = ref(x), ref.features(x)
    pairs = [(logits, want_logits)] + [(taps[k], f) for k, f in zip(TAPS, feats)]
    return max(float((got - want).abs().max() / want.std()) for got, want in pairs)


def _geometries(shape):
    """Each block's geometry over a clip of ``shape`` (the tiny model's)."""
    grid = [-(-s // p) for s, p in zip(shape[2:], (2, 4, 4))]
    out = []
    for i in range(4):
        if i:
            grid = [grid[0], -(-grid[1] // 2), -(-grid[2] // 2)]
        for shift in ((0, 0, 0), (2, 1, 1)):
            out.append(swin3d.window_geometry(grid, (4, 3, 3), shift))
    return out


def test_cases_exercise_what_they_name():
    geos = {k: _geometries(v) for k, v in CASES.items()}
    assert any(g.padded != g.grid and g.shifted for g in geos["padding"])
    assert any(g.window != g.full_window and g.shifted for g in geos["clipped"])
    assert any(g.window == g.grid and not g.shifted for g in geos["clipped"])
    assert all(c > 1 for c in geos["every_axis"][1].counts) and geos["every_axis"][1].shifted
    assert any(all(c > 1 for c in g.counts) and all(g.shift) for g in geos["every_axis"][2:])


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_reference(case):
    port, ref = _pair()
    assert sorted(n for n, _ in port.named_parameters()) == \
        sorted(n for n, _ in ref.named_parameters())
    assert _gap(port, ref, _clip(CASES[case])) <= TOL


def test_truncated_model_keeps_the_reference_taps():
    port, ref = _pair()
    short = swin3d.swin3d_tiny(taps=("stage2",), truncate=True).eval()
    short.load_state_dict({k: v for k, v in port.state_dict().items() if k in
                           short.state_dict()})
    assert len(short.layers) == 2 and short.layers[1].downsample is None and short.headless
    x = _clip(CASES["padding"])
    with torch.no_grad():
        logits, taps = short(x, normalize=False)
        want = ref.features(x)[1]
    assert logits is None and float((taps["stage2"] - want).abs().max() / want.std()) <= TOL


# -- planted faults: each must fail the comparison ---------------------------

def _no_shift_mask(monkeypatch, port):
    monkeypatch.setattr(swin3d, "_shift_mask", lambda geo, device: torch.zeros(
        math.prod(geo.counts), geo.tokens, geo.tokens, device=device))


def _unshifted_odd_block(monkeypatch, port):
    for stage in port.layers:
        for i, block in enumerate(stage.blocks):
            if i % 2:
                monkeypatch.setattr(block, "shift", (0, 0, 0))


def _no_relative_bias(monkeypatch, port):
    attention = swin3d.window_attention
    monkeypatch.setattr(swin3d, "window_attention",
                        lambda qkv, table, geo: attention(qkv, torch.zeros_like(table), geo))


def _transposed_bias_index(monkeypatch, port):
    index = swin3d._relative_index
    monkeypatch.setattr(swin3d, "_relative_index", lambda *a: index(*a).t())


def _attention_with(scores):
    """The plain attention with its q·kᵀ replaced by ``scores(q, k, geo)``."""
    def attention(qkv, table, geo):
        bw, n, _, heads, hd = qkv.shape
        q, k, v = qkv.float().unbind(2)
        attn = scores(q * hd ** -0.5, k, geo)
        index = swin3d._relative_index(geo.full_window, n, qkv.device)
        attn = attn + table[index].permute(2, 0, 1)
        if geo.shifted:
            mask = swin3d._shift_mask(geo, qkv.device)
            attn = (attn.view(-1, mask.shape[0], heads, n, n) + mask[:, None]).view(
                bw, heads, n, n)
        out = torch.einsum("bhnm,bmhc->bnhc", attn.softmax(dim=-1), v)
        return out.reshape(bw, n, heads * hd)

    return attention


def _qk_dropped(monkeypatch, port):
    def zero(q, k, geo):
        return torch.zeros(q.shape[0], q.shape[2], q.shape[1], k.shape[1])

    monkeypatch.setattr(swin3d, "window_attention", _attention_with(zero))


def _padded_keys_masked(monkeypatch, port):
    """Keys that are padding (outside the unpadded grid, in the unrolled
    frame) get −100 added, which the published code does not do."""
    def masked(q, k, geo):
        attn = torch.einsum("bnhc,bmhc->bhnm", q, k)
        inside = torch.ones(geo.padded, dtype=torch.bool)
        inside[geo.grid[0]:] = False
        inside[:, geo.grid[1]:] = False
        inside[:, :, geo.grid[2]:] = False
        inside = torch.roll(inside, tuple(-s for s in geo.shift), dims=(0, 1, 2))
        keys = swin3d.partition(inside[None, ..., None].float(), geo.window)[..., 0]
        pad = torch.where(keys > 0, 0.0, swin3d.MASK_VALUE)  # (nW, N)
        return (attn.view(-1, keys.shape[0], *attn.shape[1:])
                + pad[None, :, None, None, :]).view(attn.shape)

    monkeypatch.setattr(swin3d, "window_attention", _attention_with(masked))


@pytest.mark.parametrize("fault", [_no_shift_mask, _unshifted_odd_block, _no_relative_bias,
                                   _transposed_bias_index, _qk_dropped, _padded_keys_masked])
def test_planted_fault_fails(monkeypatch, fault):
    port, ref = _pair()
    x = _clip(CASES["padding"])
    assert _gap(port, ref, x) <= TOL
    swin3d._shift_mask.cache_clear()
    swin3d._relative_index.cache_clear()
    try:
        fault(monkeypatch, port)
        assert _gap(port, ref, x) > 100 * TOL, fault.__name__
    finally:
        monkeypatch.undo()
        swin3d._shift_mask.cache_clear()
        swin3d._relative_index.cache_clear()


# -- the registry, the evaluation, the converter and the init ----------------

def test_registry_and_taps():
    assert "swin3d_b" in video_zoo.VIDEO_BUILDERS and "swin3d_b" in video_zoo.TINY_BUILDERS
    assert video_zoo.tap_keys_for("swin3d_b") == ("stage1", "stage2")
    assert video_zoo.tap_keys_for("swin3d_b", "ilaf") == ("stage2",)
    bundle = video_zoo.get_video_model("swin3d_b", device="cpu", tiny=True)
    kernels.reset_launches()
    with torch.no_grad():
        logits, taps = bundle.apply01_taps(torch.rand(2, 3, 8, 32, 32))
    assert logits.shape == (2, 10) and [t.shape[1] for t in taps] == [32, 64]
    # the plain path ran: no kernel launch counted
    assert kernels.launches["window_attn"] == 0


def _artifacts(run_dir, labels, shape=(3, 8, 32, 32)):
    rng = np.random.RandomState(5)
    for label in labels:
        np.save(os.path.join(run_dir, f"{label}-adv.npy"), rng.randn(*shape).astype(np.float32))


def test_evaluate_run_builds_the_six_unless_swin_is_named(tmp_path):
    _artifacts(str(tmp_path), (3, 7))
    built = []

    def get_bundle(name):
        built.append(name)
        return video_zoo.get_video_model(name, device="cpu", tiny=True)

    acc = transfer.evaluate_run(str(tmp_path), get_bundle=get_bundle, device="cpu",
                                batch_size=2, log=lambda *a: None)
    assert built == list(VIDEO_MODEL_NAMES) == list(acc)
    built.clear()
    acc = transfer.evaluate_run(str(tmp_path), model_names=["swin3d_b"], get_bundle=get_bundle,
                                device="cpu", batch_size=2, single_pass=True,
                                log=lambda *a: None)
    assert built == ["swin3d_b"] == list(acc)
    header = open(tmp_path / "results_all_models_prediction.csv").readline().strip()
    assert header == "gt_label,swin3d_b-pre"


def _published_layout(state: dict) -> dict:
    """A state dict of the port's names in the published checkpoint's layout."""
    out = {}
    for name, value in state.items():
        out["cls_head.fc_cls." + name[3:] if name.startswith("fc.") else "backbone." + name] = \
            value
        if name.endswith("relative_position_bias_table"):
            out["backbone." + name.replace("bias_table", "index")] = torch.zeros(2, 2)
    return {"meta": {"epoch": 30}, "state_dict": out}


def test_converter_round_trip_and_checkpoint_file(tmp_path, monkeypatch):
    _, ref = _pair(seed=9)
    sd = convert.convert_swin3d(_published_layout(ref.state_dict()))
    assert sd.keys() == ref.state_dict().keys()
    port = swin3d.swin3d_tiny(taps=TAPS).eval()
    port.load_state_dict(sd)
    assert _gap(port, ref, _clip(CASES["clipped"])) <= TOL
    with pytest.raises(KeyError):
        convert.convert_swin3d({"neck.weight": torch.zeros(1)})
    # get_video_model lays {I2V_TPU_CKPTS}/swin3d_b.pth over its init
    monkeypatch.setitem(video_zoo.VIDEO_BUILDERS, "swin3d_b", swin3d.swin3d_tiny)
    monkeypatch.setenv("I2V_TPU_CKPTS", str(tmp_path))
    with pytest.warns(UserWarning, match="no checkpoint for 'swin3d_b'"):
        video_zoo.get_video_model("swin3d_b", device="cpu")
    torch.save(_published_layout(ref.state_dict()), tmp_path / "swin3d_b.pth")
    loaded = video_zoo.get_video_model("swin3d_b", device="cpu")
    for name, value in ref.state_dict().items():
        assert torch.equal(loaded.module.state_dict()[name], value), name


def test_random_init_draws_the_table_and_skips_the_missing_bias():
    module = swin3d.swin3d_tiny()
    registry.random_init_(module, torch.Generator().manual_seed(0))
    table = module.layers[0].blocks[0].attn.relative_position_bias_table.detach()
    assert abs(float(table.std()) - 0.02) < 0.004 and float(table.abs().max()) < 0.1
    merge = module.layers[0].downsample.reduction
    assert merge.bias is None and float(merge.weight.detach().std()) > 0
    assert torch.equal(module.norm.weight, torch.ones_like(module.norm.weight))


def test_benchmark_reads_the_kernel_by_its_name():
    """The benchmark's window-attention metrics find the kernel in a trace by
    ``port_bench.window_attn.KERNEL``: it must name the one ``__global__``
    kernel of ``csrc/window_attn.cu``, so that a rename fails here."""
    from port_bench import window_attn as bench_window_attn

    src = os.path.join(os.path.dirname(swin3d.__file__), os.pardir, "csrc", "window_attn.cu")
    with open(src) as f:
        text = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                       text)
    assert names == [bench_window_attn.KERNEL]


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (heads, grid of tokens): Swin-B's four stages at 32x224^2, both block kinds;
# a window clipped along T; a padded grid; windows whose N fills neither the
# kernel's 56-query warps nor its 28-key tiles (75 unshifted, 105 shifted along
# H); 32 window-heads, fewer than the card has SMs
CARD_SHAPES = {
    "stage1": (4, (16, 56, 56)), "stage2": (8, (16, 28, 28)), "stage3": (16, (16, 14, 14)),
    "stage4": (32, (16, 7, 7)), "clipped": (4, (4, 14, 14)), "padded": (8, (10, 9, 9)),
    "tail75": (4, (3, 5, 5)), "tail105": (4, (3, 14, 5)), "few_heads": (4, (16, 7, 14)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_is_the_plain_attention_on_card(cuda, shape, shifted, dtype):
    heads, grid = CARD_SHAPES[shape]
    geo = swin3d.window_geometry(grid, (8, 7, 7), (4, 3, 3) if shifted else (0, 0, 0))
    gen = torch.Generator(device=cuda).manual_seed(sum(grid) + heads)
    windows = 2 * math.prod(geo.counts)
    qkv = torch.randn(windows, geo.tokens, 3, heads, 32, device=cuda, generator=gen).to(dtype)
    table = 0.5 * torch.randn(2535, heads, device=cuda, generator=gen)
    kernels.reset_launches()
    got = swin3d.window_attention(qkv, table, geo)
    want = swin3d.window_attention_plain(qkv, table, geo)
    torch.cuda.synchronize()
    assert kernels.launches["window_attn"] == 1
    assert got.dtype == dtype and got.shape == (windows, geo.tokens, heads * 32)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:  # the same float32 result, each rounded to bfloat16 once
        torch.testing.assert_close(got.float(), want.float(), rtol=8e-3, atol=1e-5)


@pytest.mark.gpu
def test_kernel_refuses_autograd_and_bad_shapes_on_card(cuda):
    geo = swin3d.window_geometry((8, 7, 7), (8, 7, 7), (0, 0, 0))
    qkv = torch.zeros(1, 392, 3, 4, 32, device=cuda, requires_grad=True)
    table = torch.zeros(2535, 4, device=cuda)
    with pytest.raises(RuntimeError, match="forward only"):
        swin3d.window_attention(qkv, table, geo)
    with pytest.raises(ValueError):
        kernels.launch_window_attn(torch.zeros(1, 392, 3, 4, 16, device=cuda), table,
                                   window=geo.window, full_window=geo.full_window,
                                   shift=geo.shift, counts=geo.counts)


@pytest.mark.gpu
def test_full_depth_forward_on_card(cuda, monkeypatch):
    """24 launches (one a block) in one eager forward, each over its
    stage's (windows · heads, N, head dim); then the graphed evaluation
    forward replays its eager step 0 bit for bit."""
    from i2v_tpu_torch.parallel.replicas import replicas_for

    plans = []
    launch = kernels.launch_window_attn

    def recorded(qkv, *a, **k):
        plans.append((qkv.shape[0] * qkv.shape[3], qkv.shape[1], qkv.shape[4]))
        return launch(qkv, *a, **k)

    monkeypatch.setattr(kernels, "launch_window_attn", recorded)
    bundle = video_zoo.get_video_model("swin3d_b", device=cuda)
    x = torch.randn(2, 3, 32, 224, 224, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(22))
    kernels.reset_launches()
    with torch.inference_mode():
        eager = bundle.apply_norm(x).clone()
    assert kernels.launches["window_attn"] == 24
    assert plans == ([(2 * 128 * 4, 392, 32)] * 2 + [(2 * 32 * 8, 392, 32)] * 2
                     + [(2 * 8 * 16, 392, 32)] * 18 + [(2 * 2 * 32, 392, 32)] * 2)
    replicas = replicas_for(bundle, None, graphs=True)
    labels = torch.zeros(2, dtype=torch.long, device=cuda)
    step0 = replicas.predict(x, None, labels)[0].clone()   # eager
    replayed = replicas.predict(x, None, labels)[0].clone()  # captured, replayed
    again = replicas.predict(x, None, labels)[0].clone()
    torch.cuda.synchronize()
    assert torch.equal(step0, eager) and torch.equal(replayed, step0) and torch.equal(again, step0)
    # the eager forward, step 0 and two replays; the capture counts nothing
    assert kernels.launches["window_attn"] == 4 * 24
    assert F.softmax(eager, dim=1).isfinite().all()
