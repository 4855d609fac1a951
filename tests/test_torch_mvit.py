"""MViTv2-B (``i2v_tpu_torch/models/mvit.py``) against the benchmark's plain
reference (``port_bench/reference/mvit.py``), its pooling-attention kernel
against the plain path, and its place in the registry, the converter, the
init and the evaluation.

On the CPU the port runs the plain path, and the tiny model and the
reference, filled with the same seeded weights, give the same logits and
stage taps within 1e-5 of the reference's scale (float32 accumulated in
another order: the port adds the three relative terms before the scores,
the reference one after another; they differ by ~3e-6) at shapes that
exercise each mechanism: a query stride, key/value strides, key grids
smaller than, equal to and larger than the query grid, widths that change,
the class token, and tables that the published code resizes; each planted
fault below fails that comparison; on the CPU the block pools q, k and v
through ``attention_pool``, and the q, k and v pooling kernel's launcher
refuses what the kernel does not take before it needs a card. The ``gpu``
tests hold ``pool_attn_fwd_kernel`` to the plain path at every block shape
of MViTv2-B at 32x224^2, at B=2, and at the test variant's, and
``pool_qkv_kernel`` to the three ``attention_pool`` calls at the same
blocks in float32 and bfloat16; count 24 launches of each (one a block) in
a full-depth forward that matches the reference; and hold a captured
forward to its eager step 0, bit for bit. The file imports
neither JAX nor the JAX package, so that it runs on a machine with a card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mvit.py -m gpu``.
Without a card those tests skip."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from i2v_tpu_torch.eval import transfer  # noqa: E402
from i2v_tpu_torch.models import convert, mvit, registry, video_zoo  # noqa: E402
from i2v_tpu_torch.ops import kernels  # noqa: E402
from i2v_tpu_torch.utils import VIDEO_MODEL_NAMES  # noqa: E402
from port_bench import weights  # noqa: E402
from port_bench.entries.swin_eval import layer_norms_about_one_  # noqa: E402
from port_bench.reference import mvit as ref_mvit  # noqa: E402

TAPS = ("stage1", "stage2", "stage3", "stage4")
TOL = 1e-5
# clip (B, 3, T, H, W) of the tiny model (built for 8 x 32^2) → what it exercises
CASES = {
    # grid (4, 8, 8): block 0's keys (4, 4, 4) under its queries, block 1's
    # query stride and width change with keys (4, 8, 8) over queries (4, 4, 4),
    # block 2's equal grids, blocks 3 and 4 again strided and wider
    "built_for": (2, 3, 8, 32, 32),
    # grid (6, 8, 8): 11 temporal distances against a table of 7 rows, resized
    "longer_clip": (1, 3, 12, 32, 32),
    # grid (4, 11, 11): pooled to 6 and to 3, so the distances scale by
    # ratios that are not whole (11/6, 6/3...) and the tables are resized
    "odd_grid": (1, 3, 8, 44, 44),
}
# MViTv2-B at 32x224^2, block by block: heads, query grid, key grid
PUBLISHED_GRIDS = ([(1, (16, 56, 56), (16, 7, 7))] * 2 + [(2, (16, 28, 28), (16, 14, 14))]
                   + [(2, (16, 28, 28), (16, 7, 7))] * 2 + [(4, (16, 14, 14), (16, 14, 14))]
                   + [(4, (16, 14, 14), (16, 7, 7))] * 15 + [(8, (16, 7, 7), (16, 14, 14))]
                   + [(8, (16, 7, 7), (16, 7, 7))] * 2)


def _pair(seed=3):
    """The tiny port model (all four taps) and the reference, same weights."""
    port = mvit.mvit_tiny(taps=TAPS).eval()
    ref = ref_mvit.build(ref_mvit.TINY)
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


def _pooled(size, kernel, stride) -> tuple:
    """A grid after a pooling conv of ``kernel`` with padding ``kernel // 2``."""
    return tuple((s + 2 * (k // 2) - k) // st + 1 for s, k, st in zip(size, kernel, stride))


def _grids(spec, clip_shape):
    """Each block's (query grid, key grid, table rows, rows the published
    code reads) over a clip of ``clip_shape``."""
    grid = mvit.patch_grid(dict(spec, frames=clip_shape[2], hw=clip_shape[3]))
    out = []
    for s in mvit.block_specs(spec):
        q = _pooled(grid, spec["pool_kvq_kernel"], s.stride_q)
        k = _pooled(grid, spec["pool_kvq_kernel"], s.stride_kv)
        out.append((q, k, s.table_rows, (2 * max(q[0], k[0]) - 1, 2 * max(q[1], k[1]) - 1)))
        grid = q
    return out


def test_cases_exercise_what_they_name():
    built = _grids(mvit.TINY, CASES["built_for"])
    assert built[0][1][1] < built[0][0][1] and built[1][1][1] > built[1][0][1]
    assert built[2][0] == built[2][1] and all(rows == read for *_, rows, read in built)
    specs = mvit.block_specs(mvit.TINY)
    assert [s.dim_out > s.dim for s in specs] == [False, True, False, True, True]
    assert specs[0].stride_kv == (1, 2, 2) and specs[1].stride_q == (1, 2, 2)
    longer = _grids(mvit.TINY, CASES["longer_clip"])
    assert all(rows[0] == 7 and read[0] == 11 for *_, rows, read in longer)
    odd = _grids(mvit.TINY, CASES["odd_grid"])
    assert odd[0][0][1] == 11 and odd[0][1][1] == 6 and odd[0][2][1] != odd[0][3][1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_reference(case):
    port, ref = _pair()
    assert sorted(n for n, _ in port.named_parameters()) == \
        sorted(n for n, _ in ref.named_parameters())
    assert _gap(port, ref, _clip(CASES[case])) <= TOL


def test_truncated_model_keeps_the_reference_taps():
    port, ref = _pair()
    short = mvit.mvit_tiny(taps=("stage2",), truncate=True).eval()
    short.load_state_dict({k: v for k, v in port.state_dict().items() if k in
                           short.state_dict()})
    assert len(short.blocks) == 3 and short.headless and not hasattr(short, "norm")
    x = _clip(CASES["built_for"])
    with torch.no_grad():
        logits, taps = short(x, normalize=False)
        want = ref.features(x)[1]
    assert logits is None and float((taps["stage2"] - want).abs().max() / want.std()) <= TOL


def test_published_geometry():
    """MViTv2-B's blocks at 32x224^2: heads, query and key grids, adaptive
    key/value strides, table rows, parameters; the
    port's settings, the reference's and the benchmark configuration's are
    one."""
    got = [(s.heads, q, k) for s, (q, k, *_) in zip(mvit.block_specs(mvit.MVIT_V2_B),
                                                  _grids(mvit.MVIT_V2_B, (1, 3, 32, 224, 224)))]
    assert got == PUBLISHED_GRIDS
    specs = mvit.block_specs(mvit.MVIT_V2_B)
    assert [s.stride_kv for s in specs] == ([(1, 8, 8)] * 2 + [(1, 4, 4)] * 3 + [(1, 2, 2)] * 16
                                            + [(1, 1, 1)] * 3)
    assert [s.dim_out for s in specs] == [96] * 2 + [192] * 3 + [384] * 16 + [768] * 3
    assert {s.head_dim for s in specs} == {96}
    assert [s.table_rows[1] for s in specs] == [111] * 2 + [55] * 3 + [27] * 16 + [27] + [13] * 2
    assert {s.table_rows[0] for s in specs} == {31}
    assert mvit.stage_ends(mvit.MVIT_V2_B) == [1, 4, 20, 23]
    with torch.device("meta"):
        port, ref = mvit.mvit_v2_b(), ref_mvit.build(ref_mvit.PUBLISHED)
    shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in ref.named_parameters()}
    assert 51.1e6 < sum(p.numel() for p in port.parameters()) < 51.3e6
    import json

    with open(os.path.join(REPO, "port_bench", "configs", "mvit_v2_b_eval.json")) as f:
        config = json.load(f)
    for key, value in mvit.MVIT_V2_B.items():
        assert config[key] == value == ref_mvit.PUBLISHED[key], key
    assert config["layer_norm_eps"] == mvit.LN_EPS == ref_mvit.PUBLISHED["layer_norm_eps"]
    for key, value in mvit.TINY.items():
        assert ref_mvit.TINY[key] == value, key


@pytest.mark.parametrize("q,k", [(56, 7), (28, 14), (7, 14), (14, 14), (11, 6), (6, 3), (3, 7)])
def test_distance_indices_follow_the_published_formula(q, k):
    got = mvit._distance(q, k, torch.device("cpu"))
    q_ratio, k_ratio = max(k / q, 1.0), max(q / k, 1.0)
    want = [[int(i * q_ratio - j * k_ratio + (k - 1) * k_ratio) for j in range(k)]
            for i in range(q)]
    assert got.tolist() == want
    # inside a table of 2·max(q, k) − 1 rows
    assert int(got.min()) >= 0 and int(got.max()) <= 2 * max(q, k) - 2


# -- planted faults: each must fail the comparison ---------------------------

def _relative_terms_dropped(monkeypatch):
    terms = mvit.relative_terms
    monkeypatch.setattr(mvit, "relative_terms",
                        lambda *a: tuple(torch.zeros_like(t) for t in terms(*a)))


def _residual_pooling_dropped(monkeypatch):
    plain = mvit.pool_attention_plain

    def no_residual(q, k, v, terms):
        b, heads, nq1, hd = q.shape
        res = F.pad(q[:, :, 1:], (0, 0, 1, 0)).transpose(1, 2).reshape(b, nq1, heads * hd)
        return plain(q, k, v, terms) - res

    monkeypatch.setattr(mvit, "pool_attention_plain", no_residual)


def _class_token_pooled(monkeypatch):
    """The class token goes through the pooling conv too, as a grid of one."""
    pool = mvit.attention_pool

    def pooled(t, pool_fn, thw, norm=None):
        out, thw_out = pool(t, pool_fn, thw, None)
        b, n, _, c = t.shape
        cls = pool_fn(t[:, :, :1].reshape(b * n, 1, 1, 1, c).permute(0, 4, 1, 2, 3))
        out = torch.cat((cls.reshape(b, n, 1, c).to(out.dtype), out[:, :, 1:]), dim=2)
        return (out if norm is None else norm(out)), thw_out

    monkeypatch.setattr(mvit, "attention_pool", pooled)


def _class_token_given_a_bias(monkeypatch):
    """The class token's row and column take the nearest spatial terms
    instead of 0."""
    def biased(q, k, v, terms):
        b, heads, nq1, hd = q.shape
        rt, rh, rw = (t.view(b, heads, nq1 - 1, t.shape[-1]) for t in terms)
        bias = (rt[..., :, None, None] + rh[..., None, :, None]
                + rw[..., None, None, :]).reshape(b, heads, nq1 - 1, -1)
        bias = F.pad(bias, (1, 0, 1, 0), mode="replicate")
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1) + bias
        x = attn.softmax(dim=-1) @ v + F.pad(q[:, :, 1:], (0, 0, 1, 0))
        return x.transpose(1, 2).reshape(b, nq1, heads * hd)

    monkeypatch.setattr(mvit, "pool_attention_plain", biased)


def _q_scaled_before_the_terms(monkeypatch):
    terms = mvit.relative_terms

    def scaled(q, *a):
        return terms(q * q.shape[-1] ** -0.5, *a)

    monkeypatch.setattr(mvit, "relative_terms", scaled)


@pytest.mark.parametrize("fault", [_relative_terms_dropped, _residual_pooling_dropped,
                                   _class_token_pooled, _class_token_given_a_bias,
                                   _q_scaled_before_the_terms])
def test_planted_fault_fails(monkeypatch, fault):
    port, ref = _pair()
    x = _clip(CASES["built_for"])
    assert _gap(port, ref, x) <= TOL
    try:
        fault(monkeypatch)
        assert _gap(port, ref, x) > 100 * TOL, fault.__name__
    finally:
        monkeypatch.undo()


# -- the registry, the evaluation, the converter and the init ----------------

def test_registry_and_taps():
    assert "mvit_v2_b" in video_zoo.VIDEO_BUILDERS and "mvit_v2_b" in video_zoo.TINY_BUILDERS
    assert "mvit_v2_b" not in VIDEO_MODEL_NAMES
    assert video_zoo.tap_keys_for("mvit_v2_b") == ("stage1", "stage2")
    assert video_zoo.tap_keys_for("mvit_v2_b", "ilaf") == ("stage2",)
    bundle = video_zoo.get_video_model("mvit_v2_b", device="cpu", tiny=True)
    assert not any(True for _ in bundle.module.buffers())
    kernels.reset_launches()
    with torch.no_grad():
        logits, taps = bundle.apply01_taps(torch.rand(2, 3, 8, 32, 32))
    assert logits.shape == (2, 10) and [tuple(t.shape) for t in taps] == \
        [(2, 96, 4, 8, 8), (2, 192, 4, 4, 4)]
    # the plain path ran: no kernel launch counted
    assert kernels.launches["pool_attn"] == 0


def test_evaluate_run_builds_the_six_unless_mvit_is_named(tmp_path):
    rng = np.random.RandomState(5)
    for label in (3, 7):
        np.save(os.path.join(tmp_path, f"{label}-adv.npy"),
                rng.randn(3, 8, 32, 32).astype(np.float32))
    built = []

    def get_bundle(name):
        built.append(name)
        return video_zoo.get_video_model(name, device="cpu", tiny=True)

    acc = transfer.evaluate_run(str(tmp_path), get_bundle=get_bundle, device="cpu",
                                batch_size=2, log=lambda *a: None)
    assert built == list(VIDEO_MODEL_NAMES) == list(acc)
    built.clear()
    acc = transfer.evaluate_run(str(tmp_path), model_names=["mvit_v2_b"],
                                get_bundle=get_bundle, device="cpu", batch_size=2,
                                single_pass=True, log=lambda *a: None)
    assert built == ["mvit_v2_b"] == list(acc)
    header = open(tmp_path / "results_all_models_prediction.csv").readline().strip()
    assert header == "gt_label,mvit_v2_b-pre"


def _published_layout(state: dict) -> dict:
    """A state dict of the port's names as PySlowFast saves it, with the
    ``module.`` prefix of a data-parallel run."""
    return {"epoch": 200, "cfg": "MVIT: ...",
            "model_state": {"module." + k: v.numpy() for k, v in state.items()}}


def test_converter_round_trip_and_checkpoint_file(tmp_path, monkeypatch):
    _, ref = _pair(seed=9)
    sd = convert.convert_mvit(_published_layout(ref.state_dict()))
    assert sd.keys() == ref.state_dict().keys()
    assert all(v.dtype == torch.float32 for v in sd.values())
    port = mvit.mvit_tiny(taps=TAPS).eval()
    port.load_state_dict(sd)
    assert _gap(port, ref, _clip(CASES["built_for"])) <= TOL
    with pytest.raises(KeyError):
        convert.convert_mvit({"pos_embed": torch.zeros(1)})
    # get_video_model lays {I2V_TPU_CKPTS}/mvit_v2_b.pyth over its init
    monkeypatch.setitem(video_zoo.VIDEO_BUILDERS, "mvit_v2_b", mvit.mvit_tiny)
    monkeypatch.setenv("I2V_TPU_CKPTS", str(tmp_path))
    with pytest.warns(UserWarning, match="no checkpoint for 'mvit_v2_b'"):
        video_zoo.get_video_model("mvit_v2_b", device="cpu")
    torch.save({"model_state": dict(ref.state_dict())}, tmp_path / "mvit_v2_b.pyth")
    loaded = video_zoo.get_video_model("mvit_v2_b", device="cpu")
    for name, value in ref.state_dict().items():
        assert torch.equal(loaded.module.state_dict()[name], value), name


def test_random_init_draws_the_tables_and_the_token():
    module = mvit.mvit_tiny()
    registry.random_init_(module, torch.Generator().manual_seed(0))
    attn = module.blocks[0].attn
    for table in (attn.rel_pos_h, attn.rel_pos_w, attn.rel_pos_t, module.cls_token):
        t = table.detach()
        assert abs(float(t.std()) - 0.02) < 0.006 and float(t.abs().max()) < 0.1
    for pool in (attn.pool_q, attn.pool_k, attn.pool_v):
        assert pool.bias is None and float(pool.weight.detach().std()) > 0
    assert torch.equal(attn.norm_q.weight, torch.ones_like(attn.norm_q.weight))
    proj = module.blocks[1].proj  # the skip's linear where the width changes
    assert proj is not None and float(proj.bias.detach().abs().max()) == 0


def test_reference_imports_nothing_of_the_port():
    script = ("import sys\n"
              "for name in ('jax', 'jaxlib', 'flax', 'optax', 'i2v_tpu', 'i2v_tpu_torch'):\n"
              "    sys.modules[name] = None\n"
              "import port_bench.reference.mvit, port_bench.pool_attn, port_bench.pool_qkv\n")
    subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True, timeout=300)


def test_benchmark_reads_the_kernel_by_its_name():
    """The benchmark's pooling-attention metrics find the kernel in a trace
    by ``port_bench.pool_attn.KERNEL``: it must name the one ``__global__``
    kernel of ``csrc/pool_attn.cu``, so that a rename fails here."""
    from port_bench import pool_attn as bench_pool_attn

    src = os.path.join(os.path.dirname(mvit.__file__), os.pardir, "csrc", "pool_attn.cu")
    with open(src) as f:
        text = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                       text)
    assert names == [bench_pool_attn.KERNEL]


def test_benchmark_reads_the_pooling_kernel_by_its_name():
    """``pool_qkv_ms_per_clip.mvit`` finds the q, k and v pooling kernel by
    ``port_bench.pool_qkv.KERNEL``, the one ``__global__`` kernel of
    ``csrc/pool_qkv.cu``; no conv class and no pooling-attention reader
    counts it."""
    from port_bench import pool_attn as bench_pool_attn
    from port_bench import pool_qkv as bench_pool_qkv
    from port_bench import trace

    src = os.path.join(os.path.dirname(mvit.__file__), os.pardir, "csrc", "pool_qkv.cu")
    with open(src) as f:
        text = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                       text)
    assert names == [bench_pool_qkv.KERNEL]
    kernel = f"void (anonymous namespace)::{bench_pool_qkv.KERNEL}<float>(Args)"
    assert trace.kernel_class(kernel) not in trace.CONV_CLASSES
    assert bench_pool_attn.KERNEL not in kernel and "conv" not in kernel


def test_block_pools_through_attention_pool_on_cpu(monkeypatch):
    """Off the card each block pools q, k and v with three ``attention_pool``
    calls (the kernel's oracle, which the planted faults patch), and the
    skip's max-pool with a fourth where the block strides its queries; no
    kernel launches."""
    port, ref = _pair()
    calls = []
    pool = mvit.attention_pool

    def counted(t, pool_fn, thw, norm=None):
        calls.append(norm is not None)
        return pool(t, pool_fn, thw, norm)

    monkeypatch.setattr(mvit, "attention_pool", counted)
    kernels.reset_launches()
    x = _clip(CASES["built_for"])
    assert _gap(port, ref, x) <= TOL
    strided = sum(any(s > 1 for s in spec.stride_q) for spec in mvit.block_specs(mvit.TINY))
    assert calls.count(True) == 3 * len(port.blocks) and calls.count(False) == strided == 3
    assert kernels.launches["pool_qkv"] == 0 and kernels.launches["pool_attn"] == 0


def _pool_args(dtype=torch.float32, device="cpu", heads=2, grid=(4, 4, 4)):
    """A launch's arguments: qkv (2, 1 + T·H·W, 3, heads, 96), the weights, the
    norms."""
    gen = torch.Generator().manual_seed(7)
    qkv = torch.randn(2, 1 + int(np.prod(grid)), 3, heads, 96, generator=gen).to(device, dtype)
    weights = [(torch.randn(96, 1, 3, 3, 3, generator=gen) / 27).to(device, dtype)
               for _ in range(3)]
    norms = [(1 + 0.01 * torch.randn(96, generator=gen).to(device),
              0.01 * torch.randn(96, generator=gen).to(device)) for _ in range(3)]
    return qkv, grid, (1, 1, 1), (1, 2, 2), weights, norms, mvit.LN_EPS


def _bad_pool_args(case):
    qkv, grid, sq, skv, weights, norms, eps = _pool_args()
    if case == "float64":
        return TypeError, (qkv.double(), grid, sq, skv, [w.double() for w in weights], norms, eps)
    if case == "weights_of_another_dtype":
        return TypeError, (qkv, grid, sq, skv, [w.bfloat16() for w in weights], norms, eps)
    if case == "bfloat16_norm":
        return TypeError, (qkv, grid, sq, skv, weights,
                           [(g.bfloat16(), b) for g, b in norms], eps)
    if case == "not_contiguous":
        return ValueError, (qkv.transpose(0, 1).contiguous().transpose(0, 1), grid, sq, skv,
                            weights, norms, eps)
    if case == "head_dim_64":
        return ValueError, (qkv[..., :64].contiguous(), grid, sq, skv,
                            [w[:64].contiguous() for w in weights], [(g[:64], b[:64])
                                                                     for g, b in norms], eps)
    if case == "grid_not_the_tokens":
        return ValueError, (qkv, (4, 4, 3), sq, skv, weights, norms, eps)
    if case == "kernel_5":
        return ValueError, (qkv, grid, sq, skv, [torch.zeros(96, 1, 5, 5, 5)] * 3, norms, eps)
    if case == "stride_0":
        return ValueError, (qkv, grid, (1, 0, 1), skv, weights, norms, eps)
    assert case == "on_the_cpu"
    return ValueError, (qkv, grid, sq, skv, weights, norms, eps)


@pytest.mark.parametrize("case", ["float64", "weights_of_another_dtype", "bfloat16_norm",
                                  "not_contiguous", "head_dim_64", "grid_not_the_tokens",
                                  "kernel_5", "stride_0", "on_the_cpu"])
def test_pool_qkv_launcher_refuses_what_the_kernel_does_not_take(case):
    """Each check raises before the launch, so on any host; a CPU tensor that
    passes every other check is refused for its device: the wrapper never
    falls back to the plain path."""
    error, args = _bad_pool_args(case)
    kernels.reset_launches()
    with pytest.raises(error, match="pool_qkv"):
        kernels.launch_pool_qkv(*args)
    assert kernels.launches["pool_qkv"] == 0


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (heads, query grid, key grid): MViTv2-B's distinct block shapes at
# 32x224^2 (blocks 0, 2, 3, 5, 6, 21 and 22) and the test variant's
CARD_SHAPES = {f"block{i}": PUBLISHED_GRIDS[i] for i in (0, 2, 3, 5, 6, 21, 22)}
CARD_SHAPES.update({"tiny0": (1, (4, 8, 8), (4, 4, 4)), "tiny4": (8, (4, 1, 1), (4, 2, 2))})


def _attention_inputs(heads, q_grid, k_grid, batch, device, seed):
    """q, k and v of unit scale as the LayerNorms leave them, and the terms of
    q against tables of std 0.1 (the benchmark's draw)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nq1, nk1 = 1 + int(np.prod(q_grid)), 1 + int(np.prod(k_grid))
    q = torch.randn(batch, heads, nq1, 96, device=device, generator=gen)
    k = torch.randn(batch, heads, nk1, 96, device=device, generator=gen)
    v = torch.randn(batch, heads, nk1, 96, device=device, generator=gen)
    tables = [0.1 * torch.randn(2 * max(a, b) - 1, 96, device=device, generator=gen)
              for a, b in zip(q_grid, k_grid)]
    terms = mvit.relative_terms(q, q_grid, k_grid, *tables)
    return q, k, v, terms


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_is_the_plain_attention_on_card(cuda, shape):
    heads, q_grid, k_grid = CARD_SHAPES[shape]
    q, k, v, terms = _attention_inputs(heads, q_grid, k_grid, 2, cuda, sum(q_grid) + heads)
    kernels.reset_launches()
    got = mvit.pool_attention(q, k, v, terms)
    want = mvit.pool_attention_plain(q, k, v, terms)
    torch.cuda.synchronize()
    assert kernels.launches["pool_attn"] == 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_refuses_autograd_and_bad_shapes_on_card(cuda):
    q, k, v, terms = _attention_inputs(2, (4, 4, 4), (4, 2, 2), 1, cuda, 0)
    with pytest.raises(RuntimeError, match="forward only"):
        mvit.pool_attention(q.requires_grad_(True), k, v, terms)
    q = q.detach()
    for bad in ((q[..., :64].contiguous(), k, v, *terms),              # head dim 64
                (q, k[:, :, :-1].contiguous(), v, *terms),             # a key short
                (q, k, v, terms[0][:, :-1].contiguous(), *terms[1:]),  # a query's terms short
                (q.transpose(2, 3), k, v, *terms)):                    # not contiguous
        with pytest.raises(ValueError):
            kernels.launch_pool_attn(*bad)
    with pytest.raises(TypeError):
        kernels.launch_pool_attn(q.double(), k, v, *terms)


# the blocks of CARD_SHAPES as the pooling sees them (heads, input grid,
# query stride, key/value stride) and the test variant's blocks 0 and 4
POOL_SHAPES = {f"block{i}": mvit.block_specs(mvit.MVIT_V2_B)[i] for i in (0, 2, 3, 5, 6, 21, 22)}
POOL_SHAPES.update({f"tiny{i}": mvit.block_specs(mvit.TINY)[i] for i in (0, 4)})


def _pooling_inputs(spec, batch, device, seed, dtype=torch.float32):
    """A block's attention module, its pooling convs drawn N(0, 1/27) and its
    norms' weights 1 + N(0, 0.01), biases N(0, 0.01), in ``dtype`` as a
    model of that compute dtype holds them; and qkv N(0, 1) in ``dtype``."""
    from i2v_tpu_torch.models.common import set_compute_dtype

    gen = torch.Generator().manual_seed(seed)
    attn = mvit.MultiScaleAttention(spec, (3, 3, 3))
    with torch.no_grad():
        for conv in (attn.pool_q, attn.pool_k, attn.pool_v):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / 27 ** 0.5)
        for norm in (attn.norm_q, attn.norm_k, attn.norm_v):
            norm.weight.copy_(1 + 0.01 * torch.randn(96, generator=gen))
            norm.bias.copy_(0.01 * torch.randn(96, generator=gen))
    attn = set_compute_dtype(attn.to(device), dtype).requires_grad_(False)
    qkv = torch.randn(batch, 1 + int(np.prod(spec.input_size)), 3, spec.heads, 96,
                      device=device, generator=torch.Generator(device=device).manual_seed(seed))
    return attn, qkv.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(POOL_SHAPES))
def test_pooling_kernel_is_the_plain_pooling_on_card(cuda, shape):
    """One launch pools q, k and v as the three ``attention_pool`` calls do,
    float32 within 1e-5 (the same taps in the same order; the norms' sums in
    another)."""
    spec = POOL_SHAPES[shape]
    attn, qkv = _pooling_inputs(spec, 2, cuda, sum(spec.input_size) + spec.heads)
    kernels.reset_launches()
    got = mvit.pool_qkv(qkv, attn, spec.input_size)
    want = mvit.pool_qkv_plain(qkv, attn, spec.input_size)
    torch.cuda.synchronize()
    assert kernels.launches["pool_qkv"] == 1
    assert got[3:] == want[3:]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.float32 and g.shape == w.shape and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["block0", "block2", "block21", "tiny4"])
def test_pooling_kernel_in_bfloat16_on_card(cuda, shape):
    """bfloat16 qkv and convs (``--control bf16``): the kernel sums the taps
    in float32 in the conv's order and rounds each pooled value to bfloat16
    before the norm, as the bfloat16 conv rounds its output, so both paths
    normalise the same values: float32 out, within 1e-5 as in float32."""
    spec = POOL_SHAPES[shape]
    attn, qkv = _pooling_inputs(spec, 2, cuda, spec.heads, torch.bfloat16)
    got = mvit.pool_qkv(qkv, attn, spec.input_size)
    want = mvit.pool_qkv_plain(qkv, attn, spec.input_size)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_pooling_kernel_refuses_autograd_and_bad_inputs_on_card(cuda):
    spec = POOL_SHAPES["tiny0"]
    attn, qkv = _pooling_inputs(spec, 2, cuda, 0)
    with pytest.raises(RuntimeError, match="forward only"):
        mvit.pool_qkv(qkv.clone().requires_grad_(True), attn, spec.input_size)
    weights = [c.weight for c in (attn.pool_q, attn.pool_k, attn.pool_v)]
    norms = [(n.weight, n.bias) for n in (attn.norm_q, attn.norm_k, attn.norm_v)]
    for bad, w, nrm in ((qkv.transpose(0, 1).contiguous().transpose(0, 1), weights, norms),
                        (qkv[..., :64].contiguous(), [t[:64].contiguous() for t in weights],
                         [(g[:64], b[:64]) for g, b in norms])):
        with pytest.raises(ValueError, match="pool_qkv"):
            kernels.launch_pool_qkv(bad, spec.input_size, spec.stride_q, spec.stride_kv, w,
                                    nrm, mvit.LN_EPS)


@pytest.mark.gpu
def test_full_depth_forward_on_card(cuda, monkeypatch):
    """24 launches of each kernel (one a block) in one eager forward, the
    attention's each over its block's (clips, heads, 1 + Nq, 1 + Nk), and no
    call of either plain path (the attention's is the only code that builds a
    (queries × keys) tensor); its logits against the reference's on the same
    weights (float32 rounding through 24 blocks, TF32 off); then the graphed
    evaluation forward replays its eager step 0 bit for bit."""
    from i2v_tpu_torch.parallel.replicas import replicas_for

    def scores_built(*a):
        raise AssertionError("the plain attention ran on the card")

    def pooled_plainly(*a):
        raise AssertionError("the plain q, k and v pooling ran on the card")

    monkeypatch.setattr(mvit, "pool_attention_plain", scores_built)
    monkeypatch.setattr(mvit, "pool_qkv_plain", pooled_plainly)
    plans = []
    launch = kernels.launch_pool_attn

    def recorded(q, k, *a):
        plans.append((q.shape[1], q.shape[2], k.shape[2]))
        return launch(q, k, *a)

    monkeypatch.setattr(kernels, "launch_pool_attn", recorded)
    bundle = video_zoo.get_video_model("mvit_v2_b", device=cuda)
    layer_norms_about_one_(weights.fill_(bundle.module, 26, 0))
    ref = layer_norms_about_one_(weights.fill_(ref_mvit.build(ref_mvit.PUBLISHED).to(cuda),
                                               26, 0))
    x = torch.randn(2, 3, 32, 224, 224, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(26))
    kernels.reset_launches()
    with torch.inference_mode():
        eager = bundle.apply_norm(x).clone()
        want = ref(x)
    assert kernels.launches["pool_attn"] == kernels.launches["pool_qkv"] == 24
    assert plans == [(h, 1 + int(np.prod(q)), 1 + int(np.prod(k))) for h, q, k in PUBLISHED_GRIDS]
    gap = float((eager - want).abs().max() / want.std())
    assert gap <= 1e-4, gap
    replicas = replicas_for(bundle, None, graphs=True)
    labels = torch.zeros(2, dtype=torch.long, device=cuda)
    step0 = replicas.predict(x, None, labels)[0].clone()   # eager
    replayed = replicas.predict(x, None, labels)[0].clone()  # captured, replayed
    again = replicas.predict(x, None, labels)[0].clone()
    torch.cuda.synchronize()
    assert torch.equal(step0, eager) and torch.equal(replayed, step0) and torch.equal(again, step0)
    # the eager forward, step 0 and two replays; the capture counts nothing
    assert kernels.launches["pool_attn"] == kernels.launches["pool_qkv"] == 4 * 24
