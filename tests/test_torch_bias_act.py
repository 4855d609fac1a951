"""The conv epilogue ``act(y + bias[c] (+ residual))``: its plain version,
its autograd Function, and the surrogates that route their biased convs
through it (ResNet, VGG-16, AlexNet, SqueezeNet-1.1).

On the CPU and the meta device the surrogates run the ops they ran before
the epilogue existed, and the tests hold them to a copy of that forward,
written out below, bit for bit and op for op. On a card the convs run
without their bias and the hand-written kernel (``csrc/bias_act.cu``) adds
it; the ``gpu`` tests hold the kernel to ``torch.relu(F.conv2d(x, w, b) +
r)`` bit for bit, and the four surrogates to the copy. The file imports
neither JAX nor the JAX package, so that it runs on a machine with a card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bias_act.py
-m gpu``. Without a card those tests skip.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu_torch.models import common  # noqa: E402
from i2v_tpu_torch.models.api import ImageModel  # noqa: E402
from i2v_tpu_torch.models.common import add_offset, collect_tap, max_pool  # noqa: E402
from i2v_tpu_torch.models.registry import build_image_model, random_init_  # noqa: E402
from i2v_tpu_torch.ops import kernels, losses, pixel  # noqa: E402

# the ENS-I2V ensemble of the benchmark's ens_i2v configuration
ENS = (("resnet", 2), ("vgg", 3), ("squeezenet", 2), ("alexnet", 3))
# its biased convs, one epilogue each a forward: ResNet-101 to stage 2 (the
# stem, 3 + 4 bottlenecks of three convs, two downsamples), VGG-16 to
# features[20], SqueezeNet-1.1 to Fire 6 (conv0 and three Fires of three),
# AlexNet to features[7]
ENS_EPILOGUES = {"resnet": 1 + 3 * 3 + 1 + 4 * 3 + 1, "vgg": 9, "squeezenet": 1 + 3 * 3,
                 "alexnet": 3}
ENS_EPILOGUES_A_FORWARD = sum(ENS_EPILOGUES.values())  # 46


# -- the surrogates' forward as it was written before the epilogue ----------

def _bottleneck_before(b, x):
    residual = x if b.downsample is None else b.downsample(x)
    y = F.relu(b.conv1(x))
    y = F.relu(b.conv2(y))
    return F.relu(b.conv3(y) + residual)


def _resnet_before(m, x01, tap_offset=None):
    taps = {}
    x = pixel.normalize(x01, channel_axis=1).to(m.dtype)
    x = F.relu(m.stem(x))
    x = max_pool(x, 3, 2, 1)
    for stage in range(m.n_stages):
        for block in range(m.stage_sizes[stage]):
            x = _bottleneck_before(getattr(m, f"layer{stage + 1}_{block}"), x)
        x = add_offset(x, tap_offset, stage + 1)
        collect_tap(taps, m.taps, stage + 1, x)
    return taps


def _vgg_before(m, x01, tap_offset=None):
    taps = {}
    x = pixel.normalize(x01, channel_axis=1).to(m.dtype)
    for kind, idx in m.plan:
        if kind == "pool":
            x = max_pool(x, 2, 2)
        else:
            x = add_offset(F.relu(getattr(m, f"conv{idx}")(x)), tap_offset, idx + 1)
            collect_tap(taps, m.taps, idx + 1, x)
    return taps


def _alexnet_before(m, x01, tap_offset=None):
    taps = {}
    x = pixel.normalize(x01, channel_axis=1).to(m.dtype)
    for conv_idx, pool_after in m.plan:
        x = add_offset(F.relu(getattr(m, f"conv{conv_idx}")(x)), tap_offset, conv_idx + 1)
        collect_tap(taps, m.taps, conv_idx + 1, x)
        if pool_after:
            x = max_pool(x, 3, 2)
    return taps


def _fire_before(f, x, offset=None, offset_on_concat=False):
    s = F.relu(f.squeeze(x))
    e1 = F.relu(f.expand1x1(s))
    e3 = F.relu(f.expand3x3(s))
    if offset is not None and not offset_on_concat:
        e3 = e3 + offset
    out = torch.cat([e1, e3], dim=1)
    if offset is not None and offset_on_concat:
        out = out + offset
    return out, e3


def _squeezenet_before(m, x01, tap_offset=None):
    taps = {}
    x = pixel.normalize(x01, channel_axis=1).to(m.dtype)
    x = F.relu(m.conv0(x))
    x = max_pool(x, 3, 2, ceil_mode=True)
    for idx, pool_before in m.plan:
        if pool_before:
            x = max_pool(x, 3, 2, ceil_mode=True)
        off = tap_offset.get(idx) if tap_offset is not None else None
        x, e3 = _fire_before(getattr(m, f"fire{idx}"), x, off, m.fire_taps)
        collect_tap(taps, m.taps, idx, x if m.fire_taps else e3)
    return taps


BEFORE = {"resnet": _resnet_before, "vgg": _vgg_before, "alexnet": _alexnet_before,
          "squeezenet": _squeezenet_before}


def _taps_before(model: ImageModel, x01, tap_offset=None):
    assert model.module.headless
    taps = BEFORE[model.name](model.module, x01, tap_offset)
    return [taps[k] for k in model.tap_keys]


def _surrogates(device, *, tiny, hw, dtype=torch.float32, seed=0):
    """The ensemble with random weights and biases drawn at 0.01, as the
    benchmark's weights are (a zero bias would hide a missing add)."""
    models = []
    for i, (name, depth) in enumerate(ENS):
        with torch.device("meta" if device == "meta" else "cpu"):
            module, taps = build_image_model(name, depth, tiny=tiny, input_hw=hw, dtype=dtype)
        if device != "meta":
            gen = torch.Generator().manual_seed(seed + i)
            random_init_(module, gen)
            with torch.no_grad():
                for mod in module.modules():
                    if isinstance(mod, torch.nn.Conv2d):
                        mod.bias.copy_(0.01 * torch.randn(mod.bias.shape, generator=gen))
        module = module.to(device).eval().requires_grad_(False)
        models.append(ImageModel(name, module, taps))
    return models


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().contiguous()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _assert_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(_bits(a), _bits(b))


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        self.ops.append((str(func), shapes))
        return out


def _step0(models, clean01, mod, taps_of):
    """The ENS-I2V cost at the modifier and its gradient, as the engines
    take them: the clean taps under no_grad, the adversarial ones through
    the rebuild."""
    with torch.no_grad():
        clean = [t for m in models for t in taps_of(m, clean01)]
    m = mod.clone().requires_grad_(True)
    adv01 = kernels.rebuild_adv(clean01, m, 16 / 255)
    adv = [t for mdl in models for t in taps_of(mdl, adv01)]
    cost = losses.i2v_cost(adv, clean)
    (g,) = torch.autograd.grad(cost, m)
    return adv, cost.detach(), g


def _taps_now(model, x01):
    return model.apply01_taps(x01)[1]


# -- the plain version ------------------------------------------------------

def _planted(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(shape, generator=gen).to(dtype)
    r = torch.randn(shape, generator=gen).to(dtype)
    b = (0.5 * torch.randn(shape[1], generator=gen)).to(dtype)
    flat_y, flat_r = y.view(-1), r.view(-1)
    plants = [(float("nan"), 0.0), (-0.0, -0.0), (0.0, -0.0), (-0.0, 0.0), (1.0, float("nan")),
              (float("inf"), -float("inf")), (-1e-3, 0.0)]
    for k, (yv, rv) in enumerate(plants):
        i = (31 * k + 2) % flat_y.numel()
        flat_y[i], flat_r[i] = yv, rv
    b[0] = -0.0
    return y, b, r


SHAPES = [(2, 3, 4, 4), (2, 5, 13, 13), (1, 3, 7, 5), (3, 2, 1, 1), (2, 4, 2, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_is_the_eager_composition(dtype, shape, residual, relu):
    y, b, r = _planted(shape, dtype, seed=len(shape) + shape[-1])
    r = r if residual else None
    want = y + b.view(1, -1, 1, 1)
    if r is not None:
        want = want + r
    want = torch.relu(want) if relu else want
    got = y.clone()
    out = pixel.bias_act(got, b, r, relu)
    assert out is got  # in place
    _assert_bits(got, want)


# -- the Function on the CPU (forward through the plain version) ------------

def _conv_out(seed, dtype=torch.float64):
    """An input, a weight, a bias and a residual for a conv whose output
    is an interior node of a graph, as in the surrogates."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 3, 6, 6, generator=gen, dtype=dtype).requires_grad_(True)
    w = torch.randn(4, 3, 3, 3, generator=gen, dtype=dtype)
    b = (0.3 * torch.randn(4, generator=gen, dtype=dtype)).requires_grad_(True)
    r = torch.randn(2, 4, 6, 6, generator=gen, dtype=dtype).requires_grad_(True)
    return x, w, b, r


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_function_forward_backward_and_double_backward(residual, relu):
    x, w, b, r = _conv_out(1)
    res = r if residual else None

    def ours(x):
        return kernels.bias_act(F.conv2d(x, w, None, padding=1), b, res, relu)

    def theirs(x):
        y = F.conv2d(x, w, None, padding=1) + b.view(1, -1, 1, 1)
        if res is not None:
            y = y + res
        return F.relu(y) if relu else y

    inputs = (x, b) + ((r,) if residual else ())
    got, want = ours(x), theirs(x)
    _assert_bits_f64(got, want)
    # first order, to x, b and r, and second order through the first
    # (Grad-CAM's double backward): d/dx of <dz/dx, v> for z = Σ out²
    v = torch.randn(x.shape, dtype=x.dtype, generator=torch.Generator().manual_seed(2))
    for fn in (ours, theirs):
        out = fn(x)
        grads = torch.autograd.grad((out * out).sum(), inputs, create_graph=True)
        second = torch.autograd.grad((grads[0] * v).sum(), inputs, allow_unused=True)
        if fn is ours:
            mine = (grads, second)
        else:
            ref = (grads, second)
    for a, c in zip(mine[0] + mine[1], ref[0] + ref[1]):
        if c is None:
            assert a is None or not a.any()
        else:
            torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert torch.autograd.gradcheck(ours, (x,))
    assert torch.autograd.gradgradcheck(ours, (x,))


def _assert_bits_f64(a, b):
    assert torch.equal(a.detach().view(torch.int64), b.detach().view(torch.int64))


def test_function_marks_its_input_dirty():
    x, w, b, r = _conv_out(3)
    y = F.conv2d(x, w, None, padding=1)
    version, ptr = y._version, y.data_ptr()
    out = kernels.bias_act(y, b, r)
    # the same tensor, written in place, with the epilogue as its history
    assert out is y and out.data_ptr() == ptr and y._version > version
    assert type(out.grad_fn).__name__ == "BiasActBackward"
    # the conv's backward needs its input and weight, not its output: the
    # in-place write leaves it intact
    out.sum().backward()
    assert x.grad is not None and b.grad is not None and r.grad is not None
    # a leaf that requires a gradient cannot be written in place
    with pytest.raises(RuntimeError):
        kernels.bias_act(torch.zeros(2, 4, 6, 6, dtype=x.dtype, requires_grad=True), b)
    # nothing requires a gradient: the plain write, no history
    with torch.no_grad():
        z = torch.full((1, 4, 2, 2), -1.0, dtype=x.dtype)
        assert kernels.bias_act(z, torch.zeros(4, dtype=x.dtype)) is z and not z.any()


def test_function_under_non_reentrant_checkpoint():
    x, w, b, r = _conv_out(4)

    w2 = torch.randn(4, 4, 3, 3, dtype=w.dtype, generator=torch.Generator().manual_seed(5))

    def block(x):
        y = kernels.bias_act(F.conv2d(x, w, None, padding=1), b, r)
        return kernels.bias_act(F.conv2d(y, w2, None, padding=1), b)

    plain = torch.autograd.grad(block(x).square().sum(), (x, b, r))
    remat = torch.autograd.grad(
        checkpoint(block, x, use_reentrant=False, preserve_rng_state=False).square().sum(),
        (x, b, r))
    for a, c in zip(remat, plain):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


# -- the dispatch: the surrogates on the CPU and the meta device ------------

def test_surrogates_on_cpu_are_the_forward_before_bit_for_bit():
    models = _surrogates("cpu", tiny=True, hw=64)
    gen = torch.Generator().manual_seed(5)
    clean01 = torch.rand(3, 3, 64, 64, generator=gen)
    mod = (torch.rand(clean01.shape, generator=gen) * 2 - 1) * (16 / 255)
    for (name, _), m in zip(ENS, models):
        _taps_before(m, clean01)  # normalize's statistics, made once and cached
        with _OpLog() as now_log:
            now = _taps_now(m, clean01)
        with _OpLog() as before_log:
            before = _taps_before(m, clean01)
        assert now_log.ops == before_log.ops, name
        for a, c in zip(now, before):
            _assert_bits(a, c)
    adv, cost, g = _step0(models, clean01, mod, _taps_now)
    adv_b, cost_b, g_b = _step0(models, clean01, mod, _taps_before)
    _assert_bits(cost, cost_b)
    _assert_bits(g, g_b)
    for a, c in zip(adv, adv_b):
        _assert_bits(a, c)


def test_surrogates_with_a_tap_offset_are_the_forward_before():
    """Grad-CAM's path: the offset is added after the ReLU, and the double
    backward of its gradient is the same."""
    models = _surrogates("cpu", tiny=True, hw=64, seed=7)
    x01 = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(8))
    for m in models:
        key = m.tap_keys[-1]
        fns = {"now": lambda off, m=m: m.module(x01, {key: off})[1][key],
               "before": lambda off, m=m: BEFORE[m.name](m.module, x01, {key: off})[key]}
        shape = fns["before"](torch.zeros(())).shape
        res = {}
        for label, fn in fns.items():
            off = torch.zeros(shape, requires_grad=True)
            tap = fn(off)
            (g,) = torch.autograd.grad(tap.square().sum(), off, create_graph=True)
            (gg,) = torch.autograd.grad(g.sum(), off)
            res[label] = (tap, g, gg)
        for a, c in zip(res["now"], res["before"]):
            _assert_bits(a, c)


def test_surrogates_on_meta_run_the_ops_before():
    """The meta device (the FLOP and byte counts' device) sees the ops of
    the forward before, at full width, and their backward."""
    models = _surrogates("meta", tiny=False, hw=224)
    for m in models:
        _taps_before(m, torch.empty(2, 3, 224, 224, device="meta"))  # the cached statistics
        logs = []
        for taps_of in (_taps_now, _taps_before):
            x = torch.empty(2, 3, 224, 224, device="meta", requires_grad=True)
            with _OpLog() as log:
                taps = taps_of(m, x)
                torch.autograd.grad(sum(t.sum() for t in taps), x)
            logs.append(log.ops)
        assert logs[0] == logs[1], m.name


def test_each_biased_conv_is_one_epilogue_counted_as_the_kernel_launches(monkeypatch):
    """With the card's dispatch taken (the kernel's launch mocked by a
    counting plain version), each biased conv of the ensemble runs the
    epilogue once a forward: 46 launches, counted into a capture's tally
    while a graph is captured and into ``launches`` at each replay."""
    plain = pixel.bias_act

    def counting(y, bias, residual=None, relu=True):
        kernels.count_launch("bias_act")
        return plain(y, bias, residual, relu)

    monkeypatch.setattr(common, "_on_card", lambda x: True)
    monkeypatch.setattr(pixel, "bias_act", counting)
    saved = dict(kernels.launches)
    try:
        models = _surrogates("meta", tiny=False, hw=224)
        x = torch.empty(2, 3, 224, 224, device="meta", requires_grad=True)
        kernels.reset_launches()
        for (name, _), m in zip(ENS, models):
            before = kernels.launches["bias_act"]
            taps = _taps_now(m, x)
            torch.autograd.grad(sum(t.sum() for t in taps), x)  # the backward launches none
            assert kernels.launches["bias_act"] - before == ENS_EPILOGUES[name], name
        assert kernels.launches["bias_act"] == ENS_EPILOGUES_A_FORWARD == 46
        kernels.reset_launches()
        with kernels.capture_tally() as tally:
            for m in models:
                _taps_now(m, x)
        assert tally["bias_act"] == 46 and kernels.launches["bias_act"] == 0
        kernels.add_launches(tally)
        kernels.add_launches(tally)
        assert kernels.launches == {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": 0,
                                    "bias_act": 92, "window_attn": 0, "pool_attn": 0, "pool_qkv": 0,
                                    "dwconv3d": 0, "global_attn": 0}
    finally:
        kernels.launches.update(saved)


def test_the_card_dispatch_computes_what_the_forward_before_does(monkeypatch):
    """The card's dispatch run on the CPU (conv without its bias, then the
    Function through the plain version): the taps and the step-0 gradient of
    the forward before, to float32 rounding (the CPU's conv adds its bias
    inside the conv, the card's after it)."""
    models = _surrogates("cpu", tiny=True, hw=64, seed=11)
    gen = torch.Generator().manual_seed(12)
    clean01 = torch.rand(2, 3, 64, 64, generator=gen)
    mod = (torch.rand(clean01.shape, generator=gen) * 2 - 1) * (16 / 255)
    want = _step0(models, clean01, mod, _taps_before)
    monkeypatch.setattr(common, "_on_card", lambda x: True)
    got = _step0(models, clean01, mod, _taps_now)
    for a, c in zip(got[0], want[0]):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-6 * float(want[2].abs().max()))
    # and under the runner's remat: the same as without it, bit for bit
    remat = _step0(models, clean01, mod, lambda m, x: checkpoint(
        _taps_now, m, x, use_reentrant=False, preserve_rng_state=False))
    _assert_bits(remat[1], got[1])
    _assert_bits(remat[2], got[2])


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    y = torch.zeros(2, 4, 3, 3)
    b = torch.zeros(4)
    with pytest.raises(TypeError):
        kernels.launch_bias_act(y.double(), b.double())
    with pytest.raises(TypeError):
        kernels.launch_bias_act(y, b.bfloat16())
    with pytest.raises(ValueError):
        kernels.launch_bias_act(y.transpose(2, 3), b)
    with pytest.raises(ValueError):
        kernels.launch_bias_act(y, torch.zeros(3))
    with pytest.raises(ValueError):
        kernels.launch_bias_act(y, b, torch.zeros(2, 4, 3, 2))
    with pytest.raises(ValueError):
        kernels.launch_bias_act(torch.zeros(4), b)
    # everything else right: the CPU is refused, there is no fallback
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch_bias_act(y, b, torch.zeros_like(y))


def test_the_kernels_names_read_as_no_class_the_benchmark_counts():
    """Every instance of the kernel, as a profiler names it, falls outside
    the benchmark trace's classes, so that no conv or elementwise metric
    counts the epilogue."""
    import re

    from port_bench import trace

    src = open(kernels._build.CSRC_DIR + "/bias_act.cu").read()
    assert re.search(r"\bbias_act_kernel\(", src)
    names = []
    for t in ("float", "__nv_bfloat16"):
        for a in (t, "uint4"):
            for res in ("false", "true"):
                for act in ("false", "true"):
                    names.append(f"void (anonymous namespace)::bias_act_kernel<{t}, {a}, {res}, "
                                 f"{act}>({a}*, {a} const*, {t} const*, long, int, long)")
    assert len(names) == 16
    for name in names:
        assert trace.kernel_class(name) == "other", name


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


# (label, N, C_in, C_out, H_in, kernel, stride, pad, residual, relu): the
# surrogates' conv shapes at 256 frames (the runner's chunk)
CARD_CONVS = [
    ("vgg conv1_2", 256, 64, 64, 224, 3, 1, 1, False, True),
    ("resnet stem", 256, 3, 64, 224, 7, 2, 3, False, True),
    ("resnet layer1 conv3 + residual", 256, 64, 256, 56, 1, 1, 0, True, True),
    ("resnet layer2 downsample", 256, 256, 512, 56, 1, 2, 0, False, False),
    ("vgg conv4_2", 256, 512, 512, 28, 3, 1, 1, False, True),
    ("squeezenet conv0, 111^2", 256, 3, 64, 224, 3, 2, 0, False, True),
    ("squeezenet fire 3 expand3x3, 55^2", 256, 16, 64, 55, 3, 1, 1, False, True),
    ("squeezenet fire 6 expand3x3, 27^2", 256, 32, 128, 27, 3, 1, 1, False, True),
    ("alexnet conv6, 13^2", 256, 192, 384, 13, 3, 1, 1, False, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CONVS, ids=[c[0] for c in CARD_CONVS])
def test_kernel_is_the_conv_composition_on_card(cuda, case, dtype):
    _, n, cin, cout, h, k, stride, pad, residual, relu = case
    gen = torch.Generator(device=cuda).manual_seed(hash(case[0]) % 2**31)
    x = torch.randn(n, cin, h, h, device=cuda, generator=gen).to(dtype)
    w = (torch.randn(cout, cin, k, k, device=cuda, generator=gen) / (cin * k * k) ** 0.5
         ).to(dtype)
    b = (0.01 * torch.randn(cout, device=cuda, generator=gen)).to(dtype)
    y = F.conv2d(x, w, None, stride, pad)
    r = torch.randn(y.shape, device=cuda, generator=gen).to(dtype) if residual else None
    want = F.conv2d(x, w, b, stride, pad)
    if r is not None:
        want = want + r
    want = torch.relu(want) if relu else want
    kernels.reset_launches()
    out = kernels.launch_bias_act(y, b, r, relu)
    torch.cuda.synchronize()
    assert out is y and kernels.launches["bias_act"] == 1
    _assert_bits(y, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES + [(3, 7, 1, 4097), (4, 3, 8, 8), (2, 6, 3, 4)])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_matches_plain_on_card_with_nans_zeros_and_ragged_planes(
        cuda, dtype, shape, residual, relu, offset):
    y, b, r = (t.to(cuda) for t in _planted(shape, dtype, seed=shape[-1] + offset))
    if offset:  # views one element into their buffers: the scalar path
        y = torch.cat([y.view(-1)[:1], y.view(-1)])[1:].view(shape)
        r = torch.cat([r.view(-1)[:1], r.view(-1)])[1:].view(shape)
    r = r if residual else None
    want = pixel.bias_act(y.clone(), b, None if r is None else r.clone(), relu)
    eager = y + b.view(1, -1, 1, 1)
    if r is not None:
        eager = eager + r
    eager = torch.relu(eager) if relu else eager
    kernels.launch_bias_act(y, b, r, relu)
    torch.cuda.synchronize()
    _assert_bits(y, want)
    _assert_bits(y, eager)


@pytest.mark.gpu
def test_kernel_wrapper_refuses_on_card(cuda):
    y = torch.zeros(2, 4, 3, 3, device=cuda)
    b = torch.zeros(4, device=cuda)
    with pytest.raises(TypeError):
        kernels.launch_bias_act(y.half(), b.half())
    with pytest.raises(ValueError):
        kernels.launch_bias_act(y.transpose(2, 3), b)
    with pytest.raises(ValueError):
        kernels.launch_bias_act(y, b.cpu())
    with pytest.raises(ValueError):
        kernels.launch_bias_act(y, b, torch.zeros(2, 4, 3, 2, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_surrogates_on_card_are_the_forward_before_bit_for_bit(cuda, dtype):
    models = _surrogates("cpu", tiny=False, hw=224, dtype=dtype, seed=20)
    models = [ImageModel(m.name, m.module.to(cuda), m.tap_keys) for m in models]
    gen = torch.Generator(device=cuda).manual_seed(21)
    clean01 = torch.rand(32, 3, 224, 224, device=cuda, generator=gen)
    mod = (torch.rand(clean01.shape, device=cuda, generator=gen) * 2 - 1) * (16 / 255)
    kernels.reset_launches()
    with torch.no_grad():
        for m in models:
            for a, c in zip(_taps_now(m, clean01), _taps_before(m, clean01)):
                _assert_bits(a, c)
    assert kernels.launches["bias_act"] == ENS_EPILOGUES_A_FORWARD
    # cuDNN's default gradient algorithms may sum in another order from one
    # call to the next; its deterministic ones make the comparison exact
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        now = _step0(models, clean01, mod, _taps_now)
        before = _step0(models, clean01, mod, _taps_before)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    _assert_bits(now[1], before[1])
    _assert_bits(now[2], before[2])


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_graphed_runner_launches_one_epilogue_a_biased_conv(cuda, remat):
    """The chunked runner at one clip in two 16-frame chunks, eager and
    graphed: the clean taps' forwards, then each step's forwards (twice
    with remat), one launch a biased conv; the costs of the forward before."""
    from i2v_tpu_torch.parallel.sharded import make_sharded_i2v_runner

    models = _surrogates("cpu", tiny=False, hw=224, seed=22)
    models = [ImageModel(m.name, m.module.to(cuda), m.tap_keys) for m in models]
    clean = torch.rand(1, 3, 32, 224, 224, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(23))
    steps, chunks = 4, 2
    forwards = chunks + steps * chunks * (2 if remat else 1)
    costs = {}
    for graphed in (False, True):
        runner = make_sharded_i2v_runner(models, steps=steps, frame_chunk=16, remat=remat,
                                         graphs=graphed)
        kernels.reset_launches()
        _, c = runner(clean)
        torch.cuda.synchronize()
        assert kernels.launches["bias_act"] == forwards * ENS_EPILOGUES_A_FORWARD, graphed
        assert kernels.launches["rebuild_bwd"] == steps * chunks
        costs[graphed] = np.asarray(c.cpu() if torch.is_tensor(c) else c).reshape(-1)
    # step 0 alike; later steps follow gradients whose cuDNN sums may differ
    # in their order from one call to the next
    assert costs[True][0] == costs[False][0]
    np.testing.assert_allclose(costs[True], costs[False], rtol=1e-5)
    # the step-0 cost of the forward before
    frames = pixel.flatten_clip_to_frames(clean)
    mod = torch.full_like(frames, 0.01 / 255)
    before = sum(_step0(models, frames[i:i + 16], mod[i:i + 16], _taps_before)[1]
                 for i in (0, 16))
    assert float(costs[False][0]) == pytest.approx(float(before), rel=1e-6)
