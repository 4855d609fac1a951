"""The conv epilogue of the video models: every conv of I3D, SlowFast and
TPN goes through :func:`i2v_tpu_torch.models.common.conv_act`, which on a
card runs the conv without its bias and adds the bias, the residual and the
ReLU in one in-place launch of ``kernels.bias_act``.

On the CPU the card's path is taken by forcing ``common._on_card``, with the
plain ``pixel.bias_act`` counted in place of the launch. It is held bit for
bit to the unfused ops as a card runs them: the conv without its bias, then
``output.add_(bias)`` (aten's order after cuDNN), the residual add and the
ReLU, each a pass of its own. The ``gpu`` tests hold the kernel to the plain
version at the video models' plane sizes and each full-width model to its
unfused forward on the card. The file imports neither JAX nor the JAX
package, so that it runs on a machine with a card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_video_epilogue.py
-m gpu``. Without a card those tests skip.
"""

import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu_torch.models import common  # noqa: E402
from i2v_tpu_torch.models.video_zoo import VIDEO_BUILDERS, get_video_model  # noqa: E402
from i2v_tpu_torch.ops import kernels, pixel  # noqa: E402

NAMES = ("i3d_resnet50", "i3d_resnet101", "slowfast_resnet50", "slowfast_resnet101",
         "tpn_resnet50", "tpn_resnet101")
# one epilogue a conv forward of one full-width clip: I3D's stem, bottlenecks
# (three convs and a downsample a stage) and five non-local blocks of four;
# SlowFast's two stems, four laterals and both pathways' bottlenecks; TPN's
# stem, bottlenecks and eleven neck convs
FULL_WIDTH_EPILOGUES = {"i3d_resnet50": 1 + 16 * 3 + 4 + 5 * 4,
                        "i3d_resnet101": 1 + 33 * 3 + 4 + 5 * 4,
                        "slowfast_resnet50": 2 + 4 + 2 * (16 * 3 + 4),
                        "slowfast_resnet101": 2 + 4 + 2 * (33 * 3 + 4),
                        "tpn_resnet50": 1 + 16 * 3 + 4 + 11,
                        "tpn_resnet101": 1 + 33 * 3 + 4 + 11}
SIX_EPILOGUES = sum(FULL_WIDTH_EPILOGUES.values())  # 698


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().contiguous()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _assert_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(_bits(a), _bits(b))


def _model(name, seed, *, remat=False, tiny=True, device="cpu"):
    """A video model with random weights and biases drawn at 0.01 (a zero
    bias would hide a missing add)."""
    bundle = get_video_model(name, device="cpu", tiny=tiny, remat=remat, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in bundle.module.modules():
            if isinstance(mod, torch.nn.Conv3d):
                mod.bias.copy_(0.01 * torch.randn(mod.bias.shape, generator=gen))
    bundle.module.to(device)
    return bundle


@pytest.fixture
def paths(monkeypatch):
    """``run(path, fn)``: ``fn()`` through the unfused ops as a card runs
    them (``"unfused"``: each conv's bias added after it, aten's way) or the
    card's fused dispatch (``"fused"``: the plain ``pixel.bias_act`` counted
    as a launch). ``counts`` holds the conv forwards of the last unfused run
    and the epilogues of the last fused one."""
    plain_bias_act = pixel.bias_act
    counts = {}

    def counting(y, bias, residual=None, relu=True):
        # what the kernel's wrapper refuses: planes that are not dense
        assert y.is_contiguous() and (residual is None or residual.is_contiguous())
        counts["epilogues"] += 1
        return plain_bias_act(y, bias, residual, relu)

    def conv_then_bias(self, x):
        # cuDNN keeps a channels-last input's layout in the conv's output,
        # whose planes the kernel would refuse
        assert x.is_contiguous() or not x.is_contiguous(memory_format=torch.channels_last_3d)
        counts["convs"] += 1
        w = self.weight
        y = self._conv_forward(x.to(w.dtype), w, None)
        return y.add_(self.bias.view((-1,) + (1,) * (y.dim() - 2)))

    def run(path, fn):
        with monkeypatch.context() as m:
            if path == "fused":
                counts["epilogues"] = 0
                m.setattr(common, "_on_card", lambda x: True)
                m.setattr(pixel, "bias_act", counting)
            else:
                counts["convs"] = 0
                m.setattr(common, "_on_card", lambda x: False)
                m.setattr(common.Conv3d, "forward", conv_then_bias)
            return fn()

    run.counts = counts
    return run


def _clip(seed, shape=(2, 3, 8, 32, 32)):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name", NAMES)
def test_fused_forward_is_the_unfused_ops_bit_for_bit(paths, name):
    """Logits and taps, with and without inference mode, and one epilogue a
    conv forward."""
    seed = NAMES.index(name)
    bundle = _model(name, seed)
    clip = _clip(100 + seed)
    want = paths("unfused", lambda: bundle.apply01_taps(clip))
    convs = paths.counts["convs"]
    assert convs > 0
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            got = paths("fused", lambda: bundle.apply01_taps(clip))
        assert paths.counts["epilogues"] == convs, mode
        _assert_bits(got[0], want[0])
        assert len(got[1]) == len(want[1]) == len(bundle.tap_keys) > 0
        for a, c in zip(got[1], want[1]):
            _assert_bits(a, c)


def _input_grad(bundle, clip, scale):
    x = clip.clone().requires_grad_(True)
    logits, taps = bundle.with_relu_grad_scale(scale).apply01_taps(x)
    loss = torch.logsumexp(logits, -1).sum() + sum(t.square().mean() for t in taps)
    (g,) = torch.autograd.grad(loss, x)
    return loss.detach(), g


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["sgm", "remat"])
def test_fused_input_gradient_is_the_unfused_ops_bit_for_bit(paths, name, case):
    """SGM's scaled ReLU backward (γ^0.5 = 0.5) reaches the epilogue's
    backward, and ``remat`` recomputes the fused forward inside the
    non-reentrant checkpoint: the loss and the input gradient of the
    unfused ops, bit for bit."""
    seed = 10 + NAMES.index(name)
    scale = 0.5 if case == "sgm" else 1.0
    clip = _clip(200 + seed)
    want = paths("unfused", lambda: _input_grad(_model(name, seed), clip, scale))
    got = paths("fused", lambda: _input_grad(_model(name, seed, remat=case == "remat"), clip,
                                             scale))
    if case == "sgm":
        assert paths.counts["epilogues"] == paths.counts["convs"]
    for a, c in zip(got, want):
        _assert_bits(a, c)
    assert want[1].abs().max() > 0


def test_sgm_scale_reaches_the_backward_and_not_the_forward(paths):
    """Through the fused path, SGM changes the input gradient (the scaled
    ReLUs are the non-stem, non-block-0 ones) and not the forward."""
    bundle = _model("i3d_resnet50", 30)
    clip = _clip(300)
    one = paths("fused", lambda: _input_grad(bundle, clip, 1.0))
    half = paths("fused", lambda: _input_grad(bundle, clip, 0.5))
    _assert_bits(one[0], half[0])
    assert not torch.equal(one[1], half[1])


def test_full_width_forward_launches_one_epilogue_a_conv(paths):
    """On the meta device, with the card's dispatch taken: each full-width
    model's forward of one 32x224^2 clip runs one epilogue a conv forward,
    698 over the six; the unfused ops run as many convs."""
    clip = torch.empty(1, 3, 32, 224, 224, device="meta")
    got = {}
    for name in NAMES:
        with torch.device("meta"):
            module = VIDEO_BUILDERS[name]().eval().requires_grad_(False)
        paths("unfused", lambda: module(clip))
        paths("fused", lambda: module(clip))
        got[name] = paths.counts["epilogues"]
        assert got[name] == paths.counts["convs"], name
    assert got == FULL_WIDTH_EPILOGUES
    assert SIX_EPILOGUES == 698


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


# (label, y's shape, with a residual): the video models' conv outputs at one
# 32x224^2 clip, planes of T·H·W from 196 to 25088 floats
VIDEO_SHAPES = [
    ("I3D stem", (1, 64, 16, 112, 112), False),
    ("I3D res2 conv3 + residual", (1, 256, 8, 56, 56), True),
    ("I3D res3 conv1", (1, 128, 8, 28, 28), False),
    ("I3D res4 conv3 + residual", (1, 1024, 8, 14, 14), True),
    ("I3D res5 conv2", (1, 512, 8, 7, 7), False),
    ("SlowFast slow res5 conv3 + residual", (1, 2048, 4, 7, 7), True),
    ("SlowFast fast res2 conv1", (1, 8, 16, 56, 56), False),
    ("TPN res5 conv3 + residual", (1, 2048, 8, 7, 7), True),
    ("TPN neck sm_0_0", (1, 2048, 32, 7, 7), False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", VIDEO_SHAPES, ids=[c[0] for c in VIDEO_SHAPES])
def test_kernel_is_the_plain_version_at_video_shapes_on_card(cuda, case, dtype):
    _, shape, residual = case
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    y = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    b = (0.5 * torch.randn(shape[1], device=cuda, generator=gen)).to(dtype)
    r = torch.randn(shape, device=cuda, generator=gen).to(dtype) if residual else None
    for relu in (True, False):
        want = pixel.bias_act(y.clone(), b, None if r is None else r.clone(), relu)
        got = y.clone()
        kernels.reset_launches()
        assert kernels.launch_bias_act(got, b, r, relu) is got
        torch.cuda.synchronize()
        assert kernels.launches["bias_act"] == 1
        _assert_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
def test_full_width_forward_on_card_is_its_unfused_forward_bit_for_bit(cuda, name, monkeypatch):
    """One full-width forward of two 32x224^2 clips (a batch over 1 keeps
    cuDNN from reading a transposed view as channels-last): one launch a
    conv, and the logits and taps of the unfused ops on the card (cuDNN's
    conv with its bias, the add and the ReLU), bit for bit."""
    bundle = _model(name, 50 + NAMES.index(name), tiny=False, device=cuda)
    clip = torch.rand(2, 3, 32, 224, 224, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(51))
    with torch.inference_mode():
        kernels.reset_launches()
        got = bundle.apply01_taps(clip)
        torch.cuda.synchronize()
        assert kernels.launches["bias_act"] == FULL_WIDTH_EPILOGUES[name]
        monkeypatch.setattr(common, "_on_card", lambda x: False)
        kernels.reset_launches()
        want = bundle.apply01_taps(clip)
        assert kernels.launches["bias_act"] == 0
    _assert_bits(got[0], want[0])
    for a, c in zip(got[1], want[1]):
        _assert_bits(a, c)
