"""UniFormer-B (``i2v_tpu_torch/models/uniformer.py``) against the benchmark's
plain reference (``port_bench/reference/uniformer.py``), its depthwise conv
kernel against the plain path, and its place in the registry, the
converter, the init and the evaluation CLI.

On the CPU the port runs the plain paths, and the tiny model and the
reference, filled with the same seeded weights (every LayerNorm weight and
BatchNorm scale about 1, as the benchmark draws them), give the same logits
and stage taps within 1e-5 of the reference's scale (float32 summed in
another order: the port folds each BatchNorm into the linear after it and
runs the 1×1×1 convs as linears over tokens; they differ by ~4e-6) at
shapes that exercise each mechanism: a conv stage and an attention stage of
two and of three heads, both DPEs, the 5³ local affinity, every patch
embedding, grids whose merge drops an odd row; each planted fault below
fails that comparison; ``dwconv3d_plain`` is the grouped ``F.conv3d``; the
Sense-X checkpoint converter's BatchNorm fold matches the published
BatchNorm3d with running statistics; and the kernel's launcher refuses what
the kernel does not take before it needs a card. The ``gpu`` tests hold
``dwconv3d_kernel`` to the plain path at every stage's shape of UniFormer-B
at 32x224^2 (B=2) and at the test variant's, in float32 and bfloat16, and
``global_attn_fwd_kernel`` to the float64 plain attention, no worse than
twice SDPA's, at stage 3's and 4's shapes and ragged ones, in a graph and
refusing autograd; count 53 conv launches (a DPE a block and a 5³ a conv
block) and 27 attention launches in a full-depth forward that matches the
reference; and hold a captured forward to its eager step 0, bit for bit. The file imports neither JAX nor the JAX package, so that it
runs on a machine with a card: ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_uniformer.py -m gpu``. Without a card
those tests skip."""

import json
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

from i2v_tpu_torch.cli import evaluate as evaluate_cli  # noqa: E402
from i2v_tpu_torch.models import convert, registry, uniformer, video_zoo  # noqa: E402
from i2v_tpu_torch.ops import kernels  # noqa: E402
from i2v_tpu_torch.utils import VIDEO_MODEL_NAMES  # noqa: E402
from port_bench import dwconv3d as bench_dwconv3d  # noqa: E402
from port_bench import global_attn as bench_global_attn  # noqa: E402
from port_bench import harness, weights  # noqa: E402
from port_bench.trace import Summary  # noqa: E402
from port_bench.entries.uniformer_eval import norms_about_one_  # noqa: E402
from port_bench.reference import uniformer as ref_uniformer  # noqa: E402

TAPS = ("stage1", "stage2", "stage3", "stage4")
TOL = 1e-5
# clip (B, 3, T, H, W) of the tiny model (built for 8 x 64^2) → what it exercises
CASES = {
    # grids 4x16x16, 4x8x8, 4x4x4 (two heads over 64 tokens), 4x2x2 (three over 16)
    "built_for": (2, 3, 8, 64, 64),
    # 6 planes: the 5³ conv's temporal taps reach past both ends of more planes
    "longer_clip": (1, 3, 12, 64, 64),
    # grids 4x14x14, 4x7x7, 4x3x3 (the merge drops a row and a column), 4x1x1
    "odd_grid": (1, 3, 8, 56, 56),
}


def _pair(seed=3):
    """The tiny port model (all four taps) and the reference, same weights."""
    port = uniformer.uniformer_tiny(taps=TAPS).eval()
    ref = ref_uniformer.build(ref_uniformer.TINY)
    for m in (port, ref):
        norms_about_one_(weights.fill_(m, seed, 0))
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_reference(case):
    port, ref = _pair()
    assert sorted(n for n, _ in port.named_parameters()) == \
        sorted(n for n, _ in ref.named_parameters())
    assert _gap(port, ref, _clip(CASES[case])) <= TOL


def test_truncated_model_keeps_the_reference_taps():
    port, ref = _pair()
    short = uniformer.uniformer_tiny(taps=("stage2",), truncate=True).eval()
    short.load_state_dict({k: v for k, v in port.state_dict().items() if k in
                           short.state_dict()})
    assert not hasattr(short, "blocks3") and short.headless and not hasattr(short, "norm")
    x = _clip(CASES["built_for"])
    with torch.no_grad():
        logits, taps = short(x, normalize=False)
        want = ref.features(x)[1]
    assert logits is None and float((taps["stage2"] - want).abs().max() / want.std()) <= TOL


def test_published_geometry():
    """UniFormer-B at 32x224^2: stage grids, heads, 53 depthwise launches,
    the parameters and FLOPs the paper gives; the port's settings, the
    reference's and the benchmark configuration's are one."""
    spec = uniformer.UNIFORMER_B
    assert bench_dwconv3d.stage_grids(spec) == [(16, 56, 56), (16, 28, 28), (16, 14, 14),
                                                (16, 7, 7)]
    assert [d // spec["head_dim"] for d in spec["embed_dim"]] == [1, 2, 5, 8]
    plan = bench_dwconv3d.launches(spec)
    assert len(plan) == 53 and sum(k == 5 for k, _, _ in plan) == 13
    with torch.device("meta"):
        port, ref = uniformer.uniformer_b(), ref_uniformer.build(ref_uniformer.PUBLISHED)
    numels = {n: p.numel() for n, p in port.named_parameters()}
    assert numels == {n: p.numel() for n, p in ref.named_parameters()}
    assert 49.6e6 < sum(numels.values()) < 49.9e6  # the paper's 50 M
    from port_bench import flops

    # 258.3 G multiply-adds a view (the paper: 259 G)
    assert 516.4e9 < flops.forward_flops(ref, (1, 3, 32, 224, 224)) < 516.6e9
    with open(os.path.join(REPO, "port_bench", "configs", "uniformer_b_eval.json")) as f:
        config = json.load(f)
    for key, value in spec.items():
        assert config[key] == value == ref_uniformer.PUBLISHED[key], key
    for key, value in uniformer.TINY.items():
        assert ref_uniformer.TINY[key] == value, key


def _conv(dim, k, seed):
    gen = torch.Generator().manual_seed(seed)
    conv = uniformer.depthwise(dim, k)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / k ** 1.5)
        conv.bias.copy_(0.01 * torch.randn(dim, generator=gen))
    return conv.requires_grad_(False)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("residual", [False, True])
def test_dwconv3d_plain_is_the_grouped_conv(k, residual):
    thw, dim = (3, 5, 6), 32
    conv = _conv(dim, k, k)
    x = torch.randn(2, int(np.prod(thw)), dim, generator=torch.Generator().manual_seed(1))
    got = uniformer.dwconv3d(x, thw, conv, residual)
    grid = x.transpose(1, 2).reshape(2, dim, *thw)
    want = F.conv3d(grid, conv.weight, conv.bias, padding=k // 2, groups=dim)
    want = want.flatten(2).transpose(1, 2) + (x if residual else 0)
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- planted faults: each must fail the comparison ---------------------------

def _local_affinity_dropped(monkeypatch):
    conv = uniformer.dwconv3d
    monkeypatch.setattr(uniformer, "dwconv3d", lambda x, thw, c, residual: (
        conv(x, thw, c, residual) if residual else torch.zeros_like(x)))


def _dpe_dropped(monkeypatch):
    conv = uniformer.dwconv3d
    monkeypatch.setattr(uniformer, "dwconv3d", lambda x, thw, c, residual: (
        x if residual else conv(x, thw, c, residual)))


def _attention_within_each_token(monkeypatch):
    monkeypatch.setattr(uniformer, "global_attention_plain", lambda q, k, v: v)


def _batch_norm_left_out(monkeypatch):
    monkeypatch.setattr(uniformer, "folded_linear", lambda x, norm, linear: linear(x))


def _merge_in_the_wrong_order(monkeypatch):
    """A patch merge that gathers each 2×2 patch's tokens column-major."""
    def merge(x, thw, proj):
        b, _, c = x.shape
        t, h, w = thw
        x = x.view(b, t, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 5, 3, 6)
        weight = proj.weight.permute(0, 2, 3, 4, 1).reshape(proj.out_channels, 4 * c)
        return F.linear(x.reshape(b, -1, 4 * c), weight, proj.bias), (t, h // 2, w // 2)

    monkeypatch.setattr(uniformer, "patch_merge", merge)


@pytest.mark.parametrize("fault", [_local_affinity_dropped, _dpe_dropped,
                                   _attention_within_each_token, _batch_norm_left_out,
                                   _merge_in_the_wrong_order])
def test_planted_fault_fails(monkeypatch, fault):
    port, ref = _pair()
    x = _clip(CASES["built_for"])
    assert _gap(port, ref, x) <= TOL
    try:
        fault(monkeypatch)
        assert _gap(port, ref, x) > 100 * TOL, fault.__name__
    finally:
        monkeypatch.undo()


def test_blocks_run_the_plain_paths_on_cpu(monkeypatch):
    """Off the card every depthwise conv goes through ``dwconv3d_plain`` (a
    DPE a block, a 5³ a conv block) and the attention through
    ``global_attention_plain``; neither kernel launches."""
    calls = {"conv": [], "attention": 0}
    conv, attention = uniformer.dwconv3d_plain, uniformer.global_attention_plain

    def counted_conv(x, thw, c, residual):
        calls["conv"].append((c.kernel_size[0], x.shape[2], int(np.prod(thw))))
        return conv(x, thw, c, residual)

    def counted_attention(q, k, v):
        calls["attention"] += 1
        return attention(q, k, v)

    monkeypatch.setattr(uniformer, "dwconv3d_plain", counted_conv)
    monkeypatch.setattr(uniformer, "global_attention_plain", counted_attention)
    port, ref = _pair()
    kernels.reset_launches()
    assert _gap(port, ref, _clip(CASES["built_for"])) <= TOL
    tiny = dict(uniformer.TINY)
    assert calls["conv"] == bench_dwconv3d.launches(tiny)
    assert calls["attention"] == sum(tiny["depth"][tiny["conv_stages"]:])
    assert kernels.launches["dwconv3d"] == 0 and kernels.launches["global_attn"] == 0


@pytest.mark.parametrize("heads,n", [(2, 64), (3, 17)])
def test_global_attention_on_cpu_is_the_plain_path(heads, n):
    """Off the card ``global_attention`` is ``global_attention_plain`` in
    the projection's layout (B, N, heads·hd), q, k and v read from a qkv
    output as the model views it; no kernel launches."""
    qkv = torch.randn(2, n, 3, heads, 64, generator=torch.Generator().manual_seed(n))
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    kernels.reset_launches()
    got = uniformer.global_attention(q, k, v)
    want = torch.softmax(q @ k.transpose(-2, -1) / 8, dim=-1) @ v
    assert got.shape == (2, n, heads * 64) and kernels.launches["global_attn"] == 0
    torch.testing.assert_close(got, want.transpose(1, 2).reshape(2, n, heads * 64),
                               rtol=0, atol=0)


# -- the registry, the evaluation, the converter and the init ----------------

def test_registry_and_taps():
    assert "uniformer_b" in video_zoo.VIDEO_BUILDERS and "uniformer_b" in video_zoo.TINY_BUILDERS
    assert "uniformer_b" not in VIDEO_MODEL_NAMES
    assert video_zoo.tap_keys_for("uniformer_b") == ("stage1", "stage2")
    assert video_zoo.tap_keys_for("uniformer_b", "ilaf") == ("stage2",)
    bundle = video_zoo.get_video_model("uniformer_b", device="cpu", tiny=True)
    assert not any(True for _ in bundle.module.buffers())
    with torch.no_grad():
        logits, taps = bundle.apply01_taps(torch.rand(2, 3, 8, 64, 64))
    assert logits.shape == (2, 10) and [tuple(t.shape) for t in taps] == \
        [(2, 32, 4, 16, 16), (2, 64, 4, 8, 8)]


def test_evaluate_cli_names_uniformer(tmp_path):
    """``cli.evaluate --models uniformer_b --tiny`` evaluates UniFormer alone,
    serially and in one pass, with the same one-model reports."""
    rng = np.random.RandomState(5)
    for label in (3, 7):
        np.save(os.path.join(tmp_path, f"{label}-adv.npy"),
                rng.randn(3, 8, 64, 64).astype(np.float32))
    reports = []
    for extra in ([], ["--single_pass"]):
        args = evaluate_cli.arg_parse(["--adv_path", str(tmp_path), "--models", "uniformer_b",
                                       "--tiny", "--device", "cpu", "--batch_size", "2",
                                       *extra])
        acc = evaluate_cli.run(args)
        with open(tmp_path / "results_all_models_prediction.csv") as f:
            reports.append((f.read(), acc))
    assert reports[0] == reports[1] and list(reports[0][1]) == ["uniformer_b"]
    assert reports[0][0].split("\n")[0] == "gt_label,uniformer_b-pre"


def _sense_x_layout(ref_bn) -> dict:
    """A state dict of the published BatchNorm3d model as Sense-X's
    training code saves it: under ``model_state``, the ``module.`` prefix of
    a data-parallel run."""
    return {"epoch": 110, "cfg": "UNIFORMER: ...",
            "model_state": {"module." + k: v.numpy() for k, v in ref_bn.state_dict().items()}}


def test_converter_folds_batch_norm_and_loads_the_checkpoint_file(tmp_path, monkeypatch):
    """The published model, BatchNorm3d with running statistics (eval), and
    the port loaded from its converted checkpoint give the same logits."""
    gen = torch.Generator().manual_seed(9)
    ref_bn = ref_uniformer.build(ref_uniformer.TINY, batch_norm=True)
    # weights.fill_ refuses a module with buffers: the same draw, by hand
    params = weights.draw({n: tuple(p.shape) for n, p in ref_bn.named_parameters()}, 9, 0,
                          "cpu")
    with torch.no_grad():
        for name, p in ref_bn.named_parameters():
            p.copy_(params[name])
        norms_about_one_(ref_bn)
        for m in ref_bn.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.copy_(0.5 * torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=gen))
    sd = convert.convert_uniformer(_sense_x_layout(ref_bn))
    port = uniformer.uniformer_tiny(taps=TAPS).eval()
    assert sd.keys() == port.state_dict().keys()
    assert all(v.dtype == torch.float32 for v in sd.values())
    port.load_state_dict(sd)
    x = _clip(CASES["built_for"])
    assert _gap(port, ref_bn, x) <= TOL
    # without the fold (the statistics dropped), the logits move
    plain = {k: v for k, v in _sense_x_layout(ref_bn)["model_state"].items()
             if not k.endswith(("running_mean", "running_var"))}
    port.load_state_dict(convert.convert_uniformer(plain))
    assert _gap(port, ref_bn, x) > 100 * TOL
    with pytest.raises(KeyError):
        convert.convert_uniformer({"pos_embed": torch.zeros(1)})
    # get_video_model lays {I2V_TPU_CKPTS}/uniformer_b.pth over its init
    monkeypatch.setitem(video_zoo.VIDEO_BUILDERS, "uniformer_b", uniformer.uniformer_tiny)
    monkeypatch.setenv("I2V_TPU_CKPTS", str(tmp_path))
    with pytest.warns(UserWarning, match="no checkpoint for 'uniformer_b'"):
        video_zoo.get_video_model("uniformer_b", device="cpu")
    torch.save({"model_state": dict(ref_bn.state_dict())}, tmp_path / "uniformer_b.pth")
    loaded = video_zoo.get_video_model("uniformer_b", device="cpu")
    for name, value in sd.items():
        assert torch.equal(loaded.module.state_dict()[name], value), name


def test_random_init_draws_the_convs_and_keeps_the_norms():
    module = uniformer.uniformer_tiny()
    registry.random_init_(module, torch.Generator().manual_seed(0))
    block = module.blocks1[0]
    for norm in (block.norm1, block.norm2, module.norm):
        assert torch.equal(norm.weight, torch.ones_like(norm.weight))
        assert float(norm.bias.detach().abs().max()) == 0
    for conv in (block.pos_embed, block.attn):
        w = conv.weight.detach()
        assert abs(float(w.std()) * w[0].numel() ** 0.5 - 1) < 0.3
        assert float(conv.bias.detach().abs().max()) == 0


def test_reference_imports_nothing_of_the_port():
    script = ("import sys\n"
              "for name in ('jax', 'jaxlib', 'flax', 'optax', 'i2v_tpu', 'i2v_tpu_torch'):\n"
              "    sys.modules[name] = None\n"
              "import port_bench.reference.uniformer, port_bench.dwconv3d\n"
              "import port_bench.entries.uniformer_eval\n")
    subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True, timeout=300)


def test_benchmark_reads_the_kernel_by_its_name():
    """``dwconv3d_ms_per_clip.uniformer`` and ``dwconv3d_roofline`` find the
    kernel by ``port_bench.dwconv3d.KERNEL``, the one ``__global__`` kernel
    of ``csrc/dwconv3d.cu``, so that a rename fails here."""
    src = os.path.join(os.path.dirname(uniformer.__file__), os.pardir, "csrc", "dwconv3d.cu")
    with open(src) as f:
        text = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                       text)
    assert names == [bench_dwconv3d.KERNEL]


def test_benchmark_reads_the_attention_kernel_by_its_name():
    """``global_attn_ms_per_clip.uniformer`` and ``global_attn_roofline``
    find the port's kernel by the first of ``port_bench.global_attn.KERNELS``,
    the one ``__global__`` kernel of ``csrc/global_attn.cu``."""
    src = os.path.join(os.path.dirname(uniformer.__file__), os.pardir, "csrc",
                       "global_attn.cu")
    with open(src) as f:
        text = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                       text)
    assert names == [bench_global_attn.KERNELS[0]]
    # neither a conv nor a GEMM to the trace's classes, nor the conv kernel's readers
    from port_bench import trace

    assert trace.kernel_class(OURS) == "other" and bench_dwconv3d.KERNEL not in OURS


def test_global_attention_work_by_hand():
    """UniFormer-B's 27 attention blocks a clip: stage 3's 20 of 5 heads over
    3136 tokens, stage 4's 7 of 8 heads over 784; 4·N²·64 FLOPs a head and
    q, k, v and o moved once, worked out by hand."""
    spec = dict(uniformer.UNIFORMER_B)
    plan = bench_global_attn.blocks(spec)
    assert plan == [(5, 3136, 64)] * 20 + [(8, 784, 64)] * 7
    work = bench_global_attn.clip_work(spec)
    # 3136² · 64 · 4 · 5 and 3136 · 64 · 4 · 5 · 4 bytes; 784² · 64 · 4 · 8, 784 · 64 · 4 · 8 · 4
    assert work[0] == (12_588_154_880, 16_056_320)
    assert work[-1] == (1_258_815_488, 6_422_528)
    assert sum(f for f, _ in work) == 260_574_806_016  # 50.5% of the model's 516.5 G
    # at 494.7 TFLOP/s of TF32 (/ 3) and 3.35 TB/s both shapes are bound by FLOPs:
    # 20 · 3 · 12.588 G / 494.7 T + 7 · 3 · 1.2588 G / 494.7 T = 1.52677 + 0.05344 ms
    bound = bench_global_attn.bound_s(spec, 1, 494.7e12, 3.35e12)
    assert abs(bound - (20 * 3 * 12_588_154_880 + 7 * 3 * 1_258_815_488) / 494.7e12) < 1e-12
    assert abs(bound - 1.580199e-3) < 1e-9
    assert abs(bench_global_attn.bound_s(spec, 32, 494.7e12, 3.35e12) - 32 * bound) < 1e-12
    # at 2 x 32^2 (grids 1x2x2 and 1x1x1) with no FLOP limit, the bytes' time:
    # 20 · 4 · 5 · 4 · 64 · 4 + 7 · 4 · 8 · 1 · 64 · 4 bytes at 1 B/s
    small = dict(spec, hw=32, frames=2)
    assert bench_global_attn.blocks(small) == [(5, 4, 64)] * 20 + [(8, 1, 64)] * 7
    assert bench_global_attn.bound_s(small, 1, 1e30, 1.0) == 466_944


CARD = "NVIDIA H100 80GB HBM3"
SDPA_KERNEL = "fmha_cutlassF_f32_aligned_64x64_rf_sm80_PyTorchMemEffAttention::AttentionKernel"
OURS = "void (anonymous namespace)::global_attn_fwd_kernel<float, true>(float const*, float " \
       "const*, float const*, float*, (anonymous namespace)::Geometry)"


def _ctx(kernels_us, clips=32, card=CARD, traced=True):
    """A harness context over a synthetic trace summary of ``kernels_us``
    [(name, µs)]: the UniFormer cell's configuration and ``clips`` clips."""
    bench = harness.Bench.at(REPO)
    cell = bench.workload("uniformer_b_eval.single_b16")
    config = bench.config(cell["config"])
    trace = Summary(1e6, 9e5, [(n, 10.0 * i, us) for i, (n, us) in enumerate(kernels_us)], [],
                    []) if traced else None
    return harness.Context(cell, config, 10.0, 1.0, {"clips": clips, "sweeps": 1}, 0, card, {},
                           trace)


def _metric(name):
    return harness.Bench.at(REPO).module("metrics", name).read


@pytest.mark.parametrize("name", [OURS, SDPA_KERNEL])
def test_global_attention_readers_on_a_synthetic_trace(name):
    """Both readers take the global attention's device time whichever kernel
    ran it, the port's or SDPA's, and leave the depthwise conv's and the
    GEMMs' out: 32 clips whose attention took 32 × 3.160398 ms read 3.160398
    ms a clip and 50% of the bound (1.580199 ms a clip, worked above)."""
    per_clip_us = 2 * 1580.198944912068
    rows = [(name, 16 * per_clip_us), (name, 16 * per_clip_us),
            ("void (anonymous namespace)::dwconv3d_kernel<float, 3>", 5000.0),
            ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize256x64x8", 9000.0)]
    ms = _metric("global_attn_ms_per_clip.uniformer")(_ctx(rows))
    share = _metric("global_attn_roofline")(_ctx(rows))
    assert abs(ms - per_clip_us / 1e3) < 1e-9 and abs(share - 50.0) < 1e-9


def test_global_attention_readers_read_nothing_where_nothing_ran():
    ms, share = _metric("global_attn_ms_per_clip.uniformer"), _metric("global_attn_roofline")
    others = [("void (anonymous namespace)::dwconv3d_kernel<float, 5>", 5000.0)]
    for ctx in (_ctx(others), _ctx([(OURS, 100.0)], traced=False)):
        assert ms(ctx) is None and share(ctx) is None
    # a card without a data-sheet peak, or no clips: no share
    assert share(_ctx([(OURS, 100.0)], card="cpu")) is None
    assert share(_ctx([(OURS, 100.0)], clips=0)) is None


def _bad_launch(case):
    x = torch.randn(2, 4 * 5 * 6, 64)
    conv = _conv(64, 3, 0)
    w, b = conv.weight, conv.bias
    return {"float64": (x.double(), w.double(), b.double()),
            "weights_of_another_dtype": (x, w.bfloat16(), b),
            "channels_not_a_multiple_of_32": (x[..., :48].contiguous(), w[:48], b[:48]),
            "kernel_of_7": (x, _conv(64, 7, 0).weight, b),
            "not_contiguous": (x.transpose(0, 1).contiguous().transpose(0, 1), w, b),
            "tokens_off_the_grid": (x[:, :-1].contiguous(), w, b),
            "on_the_cpu": (x, w, b)}[case]


@pytest.mark.parametrize("case", ["float64", "weights_of_another_dtype",
                                  "channels_not_a_multiple_of_32", "kernel_of_7",
                                  "not_contiguous", "tokens_off_the_grid", "on_the_cpu"])
def test_dwconv3d_launcher_refuses_what_the_kernel_does_not_take(case):
    x, w, b = _bad_launch(case)
    error = TypeError if case in ("float64", "weights_of_another_dtype") else ValueError
    with pytest.raises(error, match="dwconv3d"):
        kernels.launch_dwconv3d(x, (4, 5, 6), w, b, True)


def _bad_attention(case):
    qkv = torch.randn(2, 40, 3, 5, 64)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    wide = torch.randn(2, 5, 40, 128)
    return {"float64": (q.double(), k.double(), v.double()),
            "dtypes_differ": (q, k.bfloat16(), v),
            "head_dim_32": tuple(t[..., :32] for t in (q, k, v)),
            "shapes_differ": (q, k[:, :, :39], v[:, :, :39]),
            "strides_differ": (q, k.contiguous(), v),
            "last_stride_not_1": (wide[..., ::2],) * 3,
            "rows_not_16_byte_aligned": tuple(t for t in torch.randn(3, 2, 5, 40, 65)[..., 1:]),
            "on_the_cpu": (q, k, v)}[case]


@pytest.mark.parametrize("case", ["float64", "dtypes_differ", "head_dim_32", "shapes_differ",
                                  "strides_differ", "last_stride_not_1",
                                  "rows_not_16_byte_aligned", "on_the_cpu"])
def test_global_attn_launcher_refuses_what_the_kernel_does_not_take(case):
    q, k, v = _bad_attention(case)
    error = TypeError if case in ("float64", "dtypes_differ") else ValueError
    with pytest.raises(error, match="global_attn"):
        kernels.launch_global_attn(q, k, v)
    assert kernels.launches["global_attn"] == 0


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (kernel, channels, grid): UniFormer-B's launches at 32x224^2 (the DPE and
# the 5³ of stages 1-2, the DPE of stages 3-4), the test variant's stage 1,
# and a grid with tails in both tile axes and three slices of 32 channels
CARD_SHAPES = {"stage1_dpe": (3, 64, (16, 56, 56)), "stage1_local": (5, 64, (16, 56, 56)),
               "stage2_dpe": (3, 128, (16, 28, 28)), "stage2_local": (5, 128, (16, 28, 28)),
               "stage3_dpe": (3, 320, (16, 14, 14)), "stage4_dpe": (3, 512, (16, 7, 7)),
               "tiny_local": (5, 32, (4, 16, 16)), "ragged": (5, 96, (3, 9, 13))}


def _card_inputs(shape, device, dtype=torch.float32, batch=2):
    k, dim, thw = CARD_SHAPES[shape]
    conv = _conv(dim, k, sum(thw) + k).to(device)
    conv.to(dtype)
    gen = torch.Generator(device=device).manual_seed(dim + k)
    x = torch.randn(batch, int(np.prod(thw)), dim, device=device, generator=gen)
    return x.to(dtype), thw, conv


@pytest.mark.gpu
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_is_the_plain_conv_on_card(cuda, shape, residual):
    x, thw, conv = _card_inputs(shape, cuda)
    kernels.reset_launches()
    got = uniformer.dwconv3d(x, thw, conv, residual)
    want = uniformer.dwconv3d_plain(x, thw, conv, residual)
    torch.cuda.synchronize()
    assert kernels.launches["dwconv3d"] == 1
    assert got.dtype == torch.float32 and got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["stage1_local", "stage3_dpe", "ragged"])
def test_kernel_in_bfloat16_on_card(cuda, shape):
    """bfloat16 x, weights and bias (``--control bf16``): the kernel widens
    them, sums in float32 and rounds once, so its output is the float32
    conv of the same bfloat16 values (plus the residual) rounded to
    bfloat16: within half a bfloat16 unit, 2^-8 of the value, and the
    float32 sums' own reordering."""
    x, thw, conv = _card_inputs(shape, cuda, torch.bfloat16)
    got = uniformer.dwconv3d(x, thw, conv, True)
    widened = uniformer.depthwise(conv.in_channels, conv.kernel_size[0]).to(cuda)
    with torch.no_grad():
        widened.weight.copy_(conv.weight.float())
        widened.bias.copy_(conv.bias.float())
    want = uniformer.dwconv3d_plain(x.float(), thw, widened, True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = (got.float() - want).abs()
    assert bool((diff <= 2 ** -8 * want.abs() + 1e-5).all()), float(diff.max())


@pytest.mark.gpu
def test_kernel_refuses_autograd_on_card(cuda):
    x, thw, conv = _card_inputs("tiny_local", cuda)
    with pytest.raises(RuntimeError, match="forward only"):
        uniformer.dwconv3d(x.requires_grad_(True), thw, conv, True)


# (clips, heads, N): UniFormer-B's stage 3 and stage 4 at B=16 and B=1, ragged
# N (a query and a key tile cut short; 785 one key past 784), and the test
# variant's stage 4 (16 tokens, one tile)
ATTN_SHAPES = {"stage3_b16": (16, 5, 3136), "stage4_b16": (16, 8, 784),
               "stage3_b1": (1, 5, 3136), "stage4_b1": (1, 8, 784),
               "ragged_100": (2, 5, 100), "ragged_785": (2, 8, 785), "tiny_16": (2, 3, 16)}


def _attn_inputs(shape, device, dtype=torch.float32):
    """q, k and v (clips, heads, N, 64) read from one qkv tensor as the
    model views it, N(0, 1)."""
    b, heads, n = ATTN_SHAPES[shape]
    gen = torch.Generator(device=device).manual_seed(n + heads)
    qkv = torch.randn(b, n, 3, heads, 64, device=device, generator=gen).to(dtype)
    return qkv.permute(2, 0, 3, 1, 4)


def _attention64(q, k, v):
    """The plain attention in float64, in the projection's layout."""
    b, heads, n, hd = q.shape
    out = uniformer.global_attention_plain(q.double(), k.double(), v.double())
    return out.transpose(1, 2).reshape(b, n, heads * hd)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(ATTN_SHAPES))
def test_global_attention_kernel_on_card(cuda, shape, dtype):
    """The kernel (one launch, the projection's layout) against the float64
    plain attention of the same values, no worse than twice SDPA's
    memory-efficient kernel (float32 through three TF32 products on the
    tensor cores, as the kernel does; bfloat16 one product, p rounded to
    bfloat16) on the same inputs: both sum in float32 in another order than
    float64, and the tensor cores' float32 sums round toward zero."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = _attn_inputs(shape, cuda, dtype)
    kernels.reset_launches()
    got = uniformer.global_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches["global_attn"] == 1
    want = _attention64(q, k, v)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        library = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(want.shape)
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    err = float((got.double() - want).abs().max())
    library_err = float((library.double() - want).abs().max())
    assert err <= 2 * library_err, (err, library_err)


@pytest.mark.gpu
def test_global_attention_kernel_in_a_graph_on_card(cuda):
    """Captured into a CUDA graph (no host sync, the current stream) and
    replayed twice: the eager output bit for bit, a launch a replay."""
    q, k, v = _attn_inputs("stage4_b1", cuda)
    kernels.reset_launches()
    eager = uniformer.global_attention(q, k, v).clone()
    graph = torch.cuda.CUDAGraph()
    with kernels.capture_tally() as tally:
        with torch.cuda.graph(graph):
            out = uniformer.global_attention(q, k, v)
    assert tally["global_attn"] == 1 and kernels.launches["global_attn"] == 1
    for _ in range(2):
        out.zero_()
        graph.replay()
        kernels.add_launches(tally)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert kernels.launches["global_attn"] == 3


@pytest.mark.gpu
def test_global_attention_refuses_autograd_on_card(cuda):
    q, k, v = _attn_inputs("ragged_100", cuda)
    with pytest.raises(RuntimeError, match="forward only"):
        uniformer.global_attention(q.requires_grad_(True), k, v)


@pytest.mark.gpu
def test_full_depth_forward_on_card(cuda, monkeypatch):
    """53 conv kernel launches in one eager forward, each at its planned
    (k, C, N), 27 attention launches (20 in stage 3, 7 in stage 4), and no
    call of either plain path; its logits against the reference's on the
    same weights (float32 rounding through 40 blocks, TF32 off); then the
    graphed evaluation forward replays its eager step 0 bit for bit, 53 and
    27 launches a replay."""
    from i2v_tpu_torch.parallel.replicas import replicas_for

    def plain_ran(*a):
        raise AssertionError("a plain path ran on the card")

    monkeypatch.setattr(uniformer, "dwconv3d_plain", plain_ran)
    monkeypatch.setattr(uniformer, "global_attention_plain", plain_ran)
    plans = []
    launch = kernels.launch_dwconv3d

    def recorded(x, thw, w, b, residual):
        plans.append((w.shape[-1], x.shape[2], x.shape[1]))
        return launch(x, thw, w, b, residual)

    monkeypatch.setattr(kernels, "launch_dwconv3d", recorded)
    bundle = video_zoo.get_video_model("uniformer_b", device=cuda)
    norms_about_one_(weights.fill_(bundle.module, 28, 0))
    ref = norms_about_one_(weights.fill_(
        ref_uniformer.build(ref_uniformer.PUBLISHED).to(cuda), 28, 0))
    x = torch.randn(2, 3, 32, 224, 224, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(28))
    kernels.reset_launches()
    with torch.inference_mode():
        eager = bundle.apply_norm(x).clone()
        want = ref(x)
    assert kernels.launches["dwconv3d"] == 53 and kernels.launches["global_attn"] == 27
    assert plans == bench_dwconv3d.launches(uniformer.UNIFORMER_B)
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
    assert kernels.launches["dwconv3d"] == 4 * 53 and kernels.launches["global_attn"] == 4 * 27
