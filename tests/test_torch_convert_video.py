"""The port's gluoncv converter (``tools/torch_convert_gluoncv.py``) against
the JAX package's (``tools/convert_gluoncv.py``), both loaded by file path
as ``tests/test_convert_video.py`` loads the JAX one.

State dicts come from the gluoncv-named fakes of
``tools/torch_gluoncv_fakes.py`` (narrow, seeded, BatchNorm statistics
randomized), from the JAX tests' own fakes (``tests/test_convert_video.py``:
``bn{k}`` and ``W.{0,1}`` namings), and from renamings of them that the
converter's other naming candidates read (``non_local``,
``nonlocal_block.theta.conv``, a TPN neck that only partly matches). Held:
  - the trees equal the JAX converter's bit for bit, keys in the same order,
    and the port's file is ``flax.serialization``'s bytes;
  - a partial tree leaves the modules that JAX's ``video_zoo._overlay``
    leaves (``missing_modules``);
  - the port's module loaded from the file gives the fake's logits within
    the JAX test's 5e-4 (BN folding changes the rounding only);
  - the warnings and the KeyError are JAX's, word for word;
  - the command line (``--report``, ``--ucf101``, a ``module.`` prefix and a
    ``{"state_dict": ...}`` wrapper) writes JAX's bytes and prints JAX's
    lines, and ``--verify --device cpu`` runs the port's model from the file
    (a narrow builder put in ``VIDEO_BUILDERS`` by the test).
"""

import importlib.util
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from flax import serialization  # noqa: E402

from tests.test_convert_video import (TorchMiniI3D, TorchMiniSlowFast,  # noqa: E402
                                      TorchMiniTPNFull, TorchNLBottleneck3D)
from tests.test_convert_video import _randomize_bn as _jax_randomize_bn  # noqa: E402
from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu.models import i3d as ji3d  # noqa: E402
from i2v_tpu.models import tpn as jtpn  # noqa: E402
from i2v_tpu.models.video_zoo import _overlay  # noqa: E402
from i2v_tpu_torch.models import convert as cv  # noqa: E402
from i2v_tpu_torch.models import i3d, slowfast, tpn, video_zoo  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jcg = _load_tool("convert_gluoncv")
pcg = _load_tool("torch_convert_gluoncv")
fk = _load_tool("torch_gluoncv_fakes")

STAGES = (1, 2, 1, 1)
I3D_INFLATE = ((1,), (1, 0), (1,), (0,))
I3D_NL = ((), (0,), (), ())


def _fake_i3d(nonlocal_pos=((), (), (), ()), sub_sample=True):
    return fk.I3DResNet(STAGES, I3D_INFLATE, nonlocal_pos, sub_sample, width=8, num_classes=10)


def _port_i3d(nonlocal_pos=((), (), (), ()), sub_sample=True):
    return i3d.I3DResNet(STAGES, I3D_INFLATE, nonlocal_pos, nl_sub_sample=sub_sample, width=8,
                         num_classes=10)


def _fake_slowfast():
    return fk.SlowFast(STAGES, width=8, beta_inv=4, fast_stride=1, slow_stride=4,
                       num_classes=10)


def _fake_tpn():
    return fk.TPN(STAGES, width=8, temporal_scales=(2, 2), num_classes=10)


def _jax_fake_i3d_nl():
    """tests/test_convert_video.py's non-local graft: ``W.{0,1}`` naming."""
    tm = TorchMiniI3D().eval()
    old = tm.res_layers[1][0]
    nlb = TorchNLBottleneck3D(old.conv1.in_channels, old.conv1.out_channels,
                              spatial_stride=2, inflate=True, downsample=True)
    nlb.load_state_dict(old.state_dict(), strict=False)
    tm.res_layers[1][0] = nlb
    return tm


def _renamed(sd, pattern, repl):
    return {re.sub(pattern, repl, k): v for k, v in sd.items()}


def _seeded(build, randomize=fk.randomize_bn):
    def make():
        torch.manual_seed(0)
        model = build().eval()
        randomize(model)
        return model
    return make


# case → (family, stage sizes, state-dict factory)
CASES = {
    "i3d": ("i3d", STAGES, _seeded(_fake_i3d)),
    "i3d_nl_sub": ("i3d", STAGES, _seeded(lambda: _fake_i3d(I3D_NL, True))),
    "i3d_nl_nosub": ("i3d", STAGES, _seeded(lambda: _fake_i3d(I3D_NL, False))),
    "i3d_nl_non_local_naming": ("i3d", STAGES, lambda: _renamed(
        _state_dict("i3d_nl_sub"), r"\.nonlocal_block\.", ".non_local.")),
    "i3d_nl_theta_conv_naming": ("i3d", STAGES, lambda: _renamed(
        _state_dict("i3d_nl_sub"), r"\.nonlocal_block\.(theta|phi|g)\.",
        r".nonlocal_block.\1.conv.")),
    "i3d_jax_fake": ("i3d", (1, 1, 1, 1), _seeded(TorchMiniI3D, _jax_randomize_bn)),
    "i3d_jax_fake_nl_W": ("i3d", (1, 1, 1, 1), _seeded(_jax_fake_i3d_nl, _jax_randomize_bn)),
    "slowfast": ("slowfast", STAGES, _seeded(_fake_slowfast)),
    "slowfast_jax_fake": ("slowfast", (1, 1, 1, 1), _seeded(TorchMiniSlowFast, _jax_randomize_bn)),
    "tpn": ("tpn", STAGES, _seeded(_fake_tpn)),
    # the neck's level_fusion_op2 under a name no candidate reads: a partial tree
    "tpn_partial_neck": ("tpn", STAGES, lambda: _renamed(
        _state_dict("tpn"), r"^necks\.level_fusion_op2\.", "necks.level_fusion_top_down.")),
    "tpn_jax_fake": ("tpn", (1, 1, 1, 1), _seeded(TorchMiniTPNFull, _jax_randomize_bn)),
}


def _state_dict(case):
    out = CASES[case][2]()
    return out.state_dict() if isinstance(out, torch.nn.Module) else out


def _trees(case):
    family, stages, _ = CASES[case]
    sd = _state_dict(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the BN-less TPN neck ops and laterals warn by design
        return jcg.FAMILIES[family](sd, stages), pcg.FAMILIES[family](sd, stages)


def _same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_equals_jax(case):
    jtree, ptree = _trees(case)
    _same_tree(ptree, jtree)
    assert any(k.endswith("_nl") for k in ptree) == ("_nl" in case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_file_is_flax_bytes(case, tmp_path):
    jtree, ptree = _trees(case)
    path = cv.save_params(ptree, "video", str(tmp_path))
    with open(path, "rb") as f:
        assert f.read() == serialization.msgpack_serialize({"params": jtree})


# case → (the port's module, the clip shape)
PORT = {
    "i3d": (_port_i3d, (1, 3, 8, 32, 32)),
    "i3d_nl_sub": (lambda: _port_i3d(I3D_NL, True), (1, 3, 8, 32, 32)),
    "i3d_nl_nosub": (lambda: _port_i3d(I3D_NL, False), (1, 3, 8, 32, 32)),
    "slowfast": (slowfast.slowfast_tiny, (1, 3, 8, 32, 32)),
    "tpn": (tpn.tpn_tiny, (1, 3, 4, 32, 32)),
}


@pytest.mark.parametrize("case", sorted(PORT))
def test_port_logits_from_file_match_fake(case, tmp_path):
    torch.manual_seed(0)
    tm = CASES[case][2]()
    _, ptree = _trees(case)
    cv.save_params(ptree, "video", str(tmp_path))
    module = cv.from_jax_params(PORT[case][0](), cv.load_params("video", str(tmp_path))).eval()
    x01 = torch.from_numpy(np.random.RandomState(1).rand(*PORT[case][1]).astype(np.float32))
    with torch.no_grad():
        want = tm(fk.normalize(x01))
        want = want[0] if isinstance(want, tuple) else want
        got, _ = module(x01)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4)


def _jax_init(module, clip_shape):
    """The JAX module's parameter tree, shapes only (no compile)."""
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(clip_shape))["params"]


# a partial tree against the JAX module it overlays and the port's twin
PARTIAL = {
    "tpn_partial_neck": (lambda: jtpn.tpn_tiny(), tpn.tpn_tiny, (1, 3, 4, 32, 32)),
    "i3d": (lambda: ji3d.I3DResNet(stage_sizes=STAGES, inflate_freq=I3D_INFLATE,
                                   nonlocal_pos=I3D_NL, width=8, num_classes=10),
            lambda: _port_i3d(I3D_NL), (1, 3, 8, 32, 32)),
}


@pytest.mark.parametrize("case", sorted(PARTIAL))
def test_missing_modules_match_overlay(case):
    """A tree without the TPN's top-down fusion, or an I3D file without the
    non-local blocks of the model it loads into: the port's overlay leaves
    the modules at init that JAX's ``_overlay`` reports."""
    jmod, pmod, shape = PARTIAL[case]
    jtree, ptree = _trees(case)
    _, want = _overlay(_jax_init(jmod(), shape), jtree)
    assert want  # the case is partial
    module = pmod()
    before = {k: v.clone() for k, v in module.state_dict().items()}
    cv.from_jax_params(module, ptree, mode="overlay")
    got = cv.missing_modules(module, ptree)
    assert got == sorted(want)
    for k, v in module.state_dict().items():
        assert (k.split(".", 1)[0] in got) == torch.equal(v, before[k]), k


def _warned(fn, *args):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn(*args)
    return [str(w.message) for w in caught]


def test_warnings_match_jax():
    """A conv whose BN the checkpoint names otherwise is converted unfolded,
    and both converters say so in the same words."""
    sd = _renamed(_state_dict("i3d"), r"^res_layers\.1\.0\.conv2\.bn\.",
                  "res_layers.1.0.conv2.norm.")
    want = _warned(jcg.convert_i3d, sd, STAGES)
    assert len(want) == 1 and "no BatchNorm folded into 'res_layers.1.0.conv2.conv'" in want[0]
    assert _warned(pcg.convert_i3d, sd, STAGES) == want
    with pytest.warns(UserWarning, match=re.escape(want[0])):
        pcg.convert_i3d(sd, STAGES)


def test_missing_conv_raises_jax_keyerror():
    sd = {k: v for k, v in _state_dict("i3d").items()
          if not k.startswith("res_layers.2.0.conv1.conv.")}
    with pytest.raises(KeyError) as want:
        jcg.convert_i3d(sd, STAGES)
    with pytest.raises(KeyError) as got:
        pcg.convert_i3d(sd, STAGES)
    assert str(got.value) == str(want.value)
    assert "no conv weight found among the naming candidates" in str(got.value)


@pytest.fixture(scope="module")
def r50_fake():
    """A width-8 I3D at ResNet-50 depth with its five non-local blocks: the
    layout ``--name i3d_resnet50`` walks."""
    torch.manual_seed(0)
    return fk.randomize_bn(fk.I3DResNet(width=8, num_classes=400).eval())


@pytest.mark.parametrize("form", ["plain", "module_prefix_wrapped", "ucf101"])
def test_command_line_writes_jax_bytes(form, r50_fake, tmp_path, capsys):
    sd = r50_fake.state_dict()
    extra = []
    if form == "module_prefix_wrapped":
        sd = {"state_dict": {f"module.{k}": v for k, v in sd.items()}}
    if form == "ucf101":
        extra = ["--ucf101"]
    pth = tmp_path / "i3d.pth"
    torch.save(sd, str(pth))
    files = {}
    for tool in (jcg, pcg):
        out = tmp_path / tool.__name__
        tool.main(["--name", "i3d_resnet50", "--weights", str(pth), "--out", str(out)] + extra)
        name = "i3d_resnet50_ucf101" if form == "ucf101" else "i3d_resnet50"
        assert capsys.readouterr().out.splitlines() == [f"wrote {out / name}.msgpack"]
        files[tool.__name__] = (out / f"{name}.msgpack").read_bytes()
    assert files["torch_convert_gluoncv"] == files["convert_gluoncv"]


def test_report_prints_jax_lines(r50_fake, tmp_path, capsys):
    pth = tmp_path / "i3d.pth"
    torch.save({f"module.{k}": v for k, v in r50_fake.state_dict().items()}, str(pth))
    lines = {}
    for tool in (jcg, pcg):
        tool.main(["--name", "i3d_resnet50", "--weights", str(pth), "--report",
                   "--out", str(tmp_path / "none")])
        lines[tool.__name__] = capsys.readouterr().out.splitlines()
    assert lines["torch_convert_gluoncv"] == lines["convert_gluoncv"]
    assert lines["convert_gluoncv"][0] == "first_stage.0.weight (8, 3, 5, 7, 7)"
    assert not (tmp_path / "none").exists()


@pytest.mark.parametrize("nonlocal_blocks", [True, False])
def test_verify_runs_the_port_model_on_cpu(nonlocal_blocks, r50_fake, tmp_path, capsys,
                                            monkeypatch):
    """``--verify --device cpu``: the file's weights over the port model's
    init, finite logits, the top-5 of the fake; without the non-local
    blocks in the checkpoint, the JAX tool's warning line naming the five
    modules left at init."""
    monkeypatch.setitem(video_zoo.VIDEO_BUILDERS, "i3d_resnet50",
                        lambda num_classes=400: i3d.i3d_resnet50(width=8, num_classes=num_classes))
    sd = r50_fake.state_dict()
    if not nonlocal_blocks:
        sd = {k: v for k, v in sd.items() if ".nonlocal_block." not in k}
    pth = tmp_path / "i3d.pth"
    torch.save(sd, str(pth))
    pcg.main(["--name", "i3d_resnet50", "--weights", str(pth), "--out", str(tmp_path),
              "--verify", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    x01 = np.random.RandomState(0).rand(1, 3, 32, 224, 224).astype(np.float32)
    if nonlocal_blocks:
        with torch.no_grad():
            want = r50_fake(fk.normalize(torch.from_numpy(x01))).numpy()
        assert lines[1] == f"torch logits: finite, top-5 {np.argsort(want[0])[-5:][::-1]}"
    else:
        jtree = jcg.convert_i3d(sd, (3, 4, 6, 3))
        _, missing = _overlay(_jax_init(ji3d.i3d_resnet50(width=8), (1, 3, 32, 224, 224)),
                              jtree)
        assert len(missing) == 5
        assert lines[1] == (f"WARNING: {len(missing)} module(s) at random init "
                            f"(unconverted): {sorted(missing)[:8]}")
        assert lines[2].startswith("torch logits: finite, top-5 ")
    assert lines[0] == f"wrote {tmp_path / 'i3d_resnet50.msgpack'}"
    assert lines[-1] == "(pass --gluoncv-cfg for a gluoncv-side logit comparison)"


def test_verify_without_a_card_stops_before_converting(r50_fake, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    pth = tmp_path / "i3d.pth"
    torch.save(r50_fake.state_dict(), str(pth))
    with pytest.raises(SystemExit, match="no CUDA device"):
        pcg.main(["--name", "i3d_resnet50", "--weights", str(pth), "--out", str(tmp_path),
                  "--verify"])
    assert not (tmp_path / "i3d_resnet50.msgpack").exists()
