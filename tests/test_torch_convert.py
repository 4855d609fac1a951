"""The port's torchvision converters (``i2v_tpu_torch.models.convert``,
``tools/torch_convert_torchvision.py``) against the JAX package's.

For each of the seven ``IMAGE_CONVERTERS`` names a seeded torch fake with
torchvision's (timm's for ViT) parameter names goes through both
converters. The fakes are the JAX tests' own (``tests/test_convert.py``),
and at the depth each name's converter walks: ResNet-101 and ResNet-50 at
their stage sizes and width 8, the whole VGG-16 and AlexNet (their
converters permute a fixed (512,7,7) and (256,6,6) flatten), DenseNet-161's
block configuration at growth 8 (the DenseNet of ``tests/test_gradcam.py``
``TestExtraZoo``, copied: it is defined inside that test). Held:
  - the trees: equal leaf for leaf, bit for bit, with the same dtypes and
    the same key order;
  - the files: the port's ``save_params`` bytes are
    ``flax.serialization.msgpack_serialize({"params": jax_tree})``;
  - the port's module loaded from the file gives the torch fake's logits
    within the tolerance the JAX test holds for that model (BN folding and
    the two frameworks' sum orders change the rounding only);
  - the command line writes the JAX tool's bytes, one name or ``--all``.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn as tnn  # noqa: E402
from flax import serialization  # noqa: E402

from tests.test_convert import (TorchAlexNet, TorchBottleneck, TorchMiniViT,  # noqa: E402
                                TorchSqueezeNet11, _randomize_bn)
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

from i2v_tpu.models import convert as jcv  # noqa: E402
from i2v_tpu_torch.models import convert as cv  # noqa: E402
from i2v_tpu_torch.models import densenet, get_image_models, resnet, vgg, vit  # noqa: E402
from i2v_tpu_torch.ops import pixel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(jcv.IMAGE_CONVERTERS)
DENSE_BLOCKS, GROWTH, INIT_F = (6, 12, 36, 24), 8, 16


class TorchMiniResNet(tnn.Module):
    """torchvision's ResNet naming at ``stage_sizes`` and a narrow width."""

    def __init__(self, stage_sizes, width=8, num_classes=1000):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, width, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.relu = tnn.ReLU(True)
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        cin = width
        for stage, n in enumerate(stage_sizes):
            feats = width * 2**stage
            blocks = [TorchBottleneck(cin if j == 0 else feats * 4, feats,
                                      2 if (j == 0 and stage > 0) else 1, j == 0)
                      for j in range(n)]
            setattr(self, f"layer{stage + 1}", tnn.Sequential(*blocks))
            cin = feats * 4
        self.fc = tnn.Linear(cin, num_classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self.fc(x.mean((2, 3)))


class TorchVGG16(tnn.Module):
    """torchvision's VGG-16 (``tests/test_convert.py`` ``TestVGGParity``)."""

    def __init__(self):
        super().__init__()
        cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M"]
        layers, cin = [], 3
        for v in cfg:
            if v == "M":
                layers.append(tnn.MaxPool2d(2, 2))
            else:
                layers += [tnn.Conv2d(cin, v, 3, padding=1), tnn.ReLU(True)]
                cin = v
        self.features = tnn.Sequential(*layers)
        self.classifier = tnn.Sequential(
            tnn.Linear(512 * 7 * 7, 4096), tnn.ReLU(True), tnn.Dropout(),
            tnn.Linear(4096, 4096), tnn.ReLU(True), tnn.Dropout(),
            tnn.Linear(4096, 1000))

    def forward(self, x):
        return self.classifier(torch.flatten(self.features(x), 1))


class TorchDenseLayer(tnn.Module):
    def __init__(self, cin, growth, bn_size=4):
        super().__init__()
        self.norm1 = tnn.BatchNorm2d(cin)
        self.conv1 = tnn.Conv2d(cin, bn_size * growth, 1, bias=False)
        self.norm2 = tnn.BatchNorm2d(bn_size * growth)
        self.conv2 = tnn.Conv2d(bn_size * growth, growth, 3, padding=1, bias=False)

    def forward(self, x):
        y = self.conv1(torch.relu(self.norm1(x)))
        y = self.conv2(torch.relu(self.norm2(y)))
        return torch.cat([x, y], 1)


class TorchDenseNet(tnn.Module):
    """torchvision's DenseNet naming (``features.denseblock{i}.denselayer{j}``,
    ``features.transition{i}``, ``features.norm{0,5}``, ``classifier``)."""

    def __init__(self, blocks=DENSE_BLOCKS, growth=GROWTH, init_f=INIT_F, num_classes=10):
        super().__init__()
        self.blocks = blocks
        feats = tnn.Module()
        feats.conv0 = tnn.Conv2d(3, init_f, 7, 2, 3, bias=False)
        feats.norm0 = tnn.BatchNorm2d(init_f)
        c = init_f
        for i, n in enumerate(blocks):
            blk = tnn.Module()
            for j in range(1, n + 1):
                setattr(blk, f"denselayer{j}", TorchDenseLayer(c, growth))
                c += growth
            setattr(feats, f"denseblock{i + 1}", blk)
            if i + 1 < len(blocks):
                tr = tnn.Module()
                tr.norm = tnn.BatchNorm2d(c)
                tr.conv = tnn.Conv2d(c, c // 2, 1, bias=False)
                setattr(feats, f"transition{i + 1}", tr)
                c //= 2
        feats.norm5 = tnn.BatchNorm2d(c)
        self.features = feats
        self.classifier = tnn.Linear(c, num_classes)

    def forward(self, x):
        f = self.features
        x = tnn.functional.max_pool2d(torch.relu(f.norm0(f.conv0(x))), 3, 2, 1)
        for i, n in enumerate(self.blocks):
            blk = getattr(f, f"denseblock{i + 1}")
            for j in range(1, n + 1):
                x = getattr(blk, f"denselayer{j}")(x)
            if i + 1 < len(self.blocks):
                tr = getattr(f, f"transition{i + 1}")
                x = tnn.functional.avg_pool2d(tr.conv(torch.relu(tr.norm(x))), 2)
        return self.classifier(torch.relu(f.norm5(x)).mean((2, 3)))


def _mini_vit():
    torch.manual_seed(0)
    tm = TorchMiniViT()
    with torch.no_grad():
        tm.cls_token.add_(torch.randn_like(tm.cls_token) * 0.1)
    return tm


# name → (torch fake, the port module it converts into, input (B, 3, H, W),
# the JAX test's tolerance for that model)
CASES = {
    "resnet": (lambda: TorchMiniResNet((3, 4, 23, 3)),
               lambda: resnet.ResNet((3, 4, 23, 3), width=8), (2, 3, 64, 64), 5e-4),
    "resnet50": (lambda: TorchMiniResNet((3, 4, 6, 3)),
                 lambda: resnet.ResNet((3, 4, 6, 3), width=8), (2, 3, 64, 64), 5e-4),
    "vgg": (TorchVGG16, vgg.VGG16, (1, 3, 224, 224), 5e-4),
    "alexnet": (TorchAlexNet, vgg.AlexNet, (2, 3, 224, 224), 2e-4),
    "squeezenet": (TorchSqueezeNet11, vgg.SqueezeNet11, (1, 3, 224, 224), 2e-4),
    "densenet": (TorchDenseNet,
                 lambda: densenet.DenseNet(DENSE_BLOCKS, growth=GROWTH, init_features=INIT_F,
                                           num_classes=10), (1, 3, 32, 32), 2e-4),
    "vit": (_mini_vit, lambda: vit.ViT(patch=8, img_size=16, dim=32, depth=2, heads=4,
                                       num_classes=10), (2, 3, 16, 16), 2e-5),
}


@pytest.fixture(scope="module")
def fakes():
    """name → a seeded torch fake in eval mode, its BatchNorms randomized,
    built at first use."""
    built = {}

    def get(name):
        if name not in built:
            torch.manual_seed(NAMES.index(name))
            tm = CASES[name][0]().eval()
            _randomize_bn(tm, seed=NAMES.index(name))
            built[name] = tm
        return built[name]

    return get


def _same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def converted(fakes, tmp_path_factory):
    """name → (the JAX converter's tree, the port's tree, the port's file),
    converted at first use."""
    out = tmp_path_factory.mktemp("ckpts")
    done = {}

    def get(name):
        if name not in done:
            sd = fakes(name).state_dict()
            path = cv.convert_torchvision(name, sd, str(out))
            done[name] = jcv.IMAGE_CONVERTERS[name](sd), cv.IMAGE_CONVERTERS[name](sd), path
        return done[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_tree_equals_jax(name, converted):
    jtree, ptree, _ = converted(name)
    _same_tree(ptree, jtree)


@pytest.mark.parametrize("name", NAMES)
def test_file_is_flax_bytes(name, converted):
    jtree, _, path = converted(name)
    assert os.path.basename(path) == f"{name}.msgpack"
    with open(path, "rb") as f:
        assert f.read() == serialization.msgpack_serialize({"params": jtree})


@pytest.mark.parametrize("name", NAMES)
def test_module_from_file_matches_torch(name, fakes, converted):
    path = converted(name)[2]
    module = cv.from_jax_params(CASES[name][1](),
                                cv.load_params(name, os.path.dirname(path))).eval()
    x01 = torch.from_numpy(np.random.RandomState(NAMES.index(name))
                           .rand(*CASES[name][2]).astype(np.float32))
    with torch.no_grad():
        want = fakes(name)(pixel.normalize(x01, channel_axis=1)).numpy()
        got, _ = module(x01)
    np.testing.assert_allclose(got.numpy(), want, atol=CASES[name][3])


def test_registry_loads_a_truncated_surrogate(fakes, tmp_path, monkeypatch):
    """The file of a whole network loads into the registry's surrogate,
    truncated at its tap (``subset``), with no random-init warning: the
    tap is the torch fake's ``features[:5]`` (tests/test_convert.py
    ``test_save_and_registry_load``)."""
    monkeypatch.setenv("I2V_TPU_CKPTS", str(tmp_path))
    tm = fakes("alexnet")
    cv.convert_torchvision("alexnet", tm.state_dict())
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bundle = get_image_models(["alexnet"], {"alexnet": 2}, device="cpu")[0]
    x01 = torch.from_numpy(np.random.RandomState(3).rand(1, 3, 224, 224).astype(np.float32))
    with torch.no_grad():
        _, taps = bundle.apply01_taps(x01)
        want = tm.features[:5](pixel.normalize(x01, channel_axis=1))
    np.testing.assert_allclose(taps[0].numpy(), want.numpy(), atol=2e-4)


@pytest.fixture(scope="module")
def weights_dir(fakes, tmp_path_factory):
    """``{name}.pth`` of every fake, the ``--all --weights-dir`` layout; the
    alexnet file wraps its state_dict as ``{"state_dict": ...}``."""
    d = tmp_path_factory.mktemp("pths")
    for name in NAMES:
        sd = fakes(name).state_dict()
        torch.save({"state_dict": sd} if name == "alexnet" else sd, str(d / f"{name}.pth"))
    return d


@pytest.mark.parametrize("select", ["one", "all"])
def test_command_line_writes_jax_bytes(select, weights_dir, tmp_path, capsys):
    if select == "one":
        argv = ["--name", "alexnet", "--weights", str(weights_dir / "alexnet.pth")]
        names = ["alexnet"]
    else:
        argv = ["--all", "--weights-dir", str(weights_dir)]
        names = NAMES
    outs = {}
    for tool in ("convert_torchvision", "torch_convert_torchvision"):
        out = tmp_path / tool
        _load_tool(tool).main(argv + ["--out", str(out)])
        lines = capsys.readouterr().out.splitlines()
        assert lines == [f"{n}: wrote {out / n}.msgpack" for n in names]
        outs[tool] = out
    for n in names:
        assert ((outs["torch_convert_torchvision"] / f"{n}.msgpack").read_bytes()
                == (outs["convert_torchvision"] / f"{n}.msgpack").read_bytes()), n


def test_command_line_needs_weights_or_download(tmp_path):
    tool = _load_tool("torch_convert_torchvision")
    with pytest.raises(SystemExit, match="provide --weights"):
        tool.main(["--name", "alexnet", "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        tool.main(["--out", str(tmp_path)])  # neither --name nor --all
