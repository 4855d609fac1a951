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
at 32x224^2 (B=2) and at the test variant's, in float32 and bfloat16; count
53 launches (a DPE a block and a 5³ a conv block) in a full-depth forward
that matches the reference; and hold a captured forward to its eager step 0,
bit for bit. The file imports neither JAX nor the JAX package, so that it
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
from port_bench import weights  # noqa: E402
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
    ``global_attention_plain``; no kernel launches."""
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
    assert kernels.launches["dwconv3d"] == 0


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


@pytest.mark.gpu
def test_full_depth_forward_on_card(cuda, monkeypatch):
    """53 kernel launches in one eager forward, each at its planned (k, C,
    N), and no call of either plain path; its logits against the
    reference's on the same weights (float32 rounding through 40 blocks,
    TF32 off); then the graphed evaluation forward replays its eager step 0
    bit for bit, 53 launches a replay."""
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
    assert kernels.launches["dwconv3d"] == 53
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
    assert kernels.launches["dwconv3d"] == 4 * 53
