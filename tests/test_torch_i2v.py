"""The port's I2V / ENS-I2V slice against the JAX package, end to end.

The same weights (JAX → port through ``from_jax_params``) and the same numpy
clips go through both attacks. The cosine objective starts at its flat
maximum, where Adam's first quasi-sign steps amplify float32 noise into
different pixel patterns, so what is compared is the cost trajectory
(rtol 2e-4, as tests/test_i2v_parity.py holds the JAX package to its torch
oracle), the ε-ball and [0,1] invariants, and the cost gradient at a generic
modifier away from the clamp ties (atol 5e-4·max|g|).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

import i2v_tpu.attacks as jattacks  # noqa: E402
from i2v_tpu.models import get_image_models as jget_image_models  # noqa: E402
from i2v_tpu.ops import losses as jlosses  # noqa: E402
from i2v_tpu.ops import pallas_kernels as pk  # noqa: E402
from i2v_tpu.ops import pixel as jpixel  # noqa: E402
from i2v_tpu.utils import artifacts as jartifacts  # noqa: E402
from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.models import ImageModel, build_image_model  # noqa: E402
from i2v_tpu_torch.models.convert import from_jax_params  # noqa: E402
from i2v_tpu_torch.ops import kernels, losses, pixel  # noqa: E402

EPS = 16 / 255
STEPS = 5
HW = 64
ENS_DEPTHS = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}
ENS_NAMES = ["resnet", "vgg", "squeezenet", "alexnet"]


def _both(names, depths):
    """Tiny JAX bundles and their port twins, sharing weights."""
    jbundles = jget_image_models(names, depths, tiny=True, input_hw=HW)
    ported = []
    for b in jbundles:
        d = depths if isinstance(depths, int) else depths[b.name]
        module, taps = build_image_model(b.name, d, tiny=True, input_hw=HW)
        from_jax_params(module, jax.tree_util.tree_map(np.asarray, b.params))
        ported.append(ImageModel(b.name, module.eval().requires_grad_(False), taps))
    return jbundles, ported


def _clips(seed):
    clips01 = np.random.RandomState(seed).rand(1, 3, 4, HW, HW).astype(np.float32)
    return clips01, np.asarray(jpixel.normalize(jnp.asarray(clips01), channel_axis=1))


def _costs(atk, name="v"):
    return [float(atk.loss_info[name][i]["cost"]) for i in range(STEPS)]


def _check_invariants(adv_norm, clips01, costs):
    adv01 = pixel.unnormalize(adv_norm, channel_axis=1).numpy()
    assert adv01.shape == clips01.shape
    assert adv01.min() >= -1e-5 and adv01.max() <= 1 + 1e-5
    assert np.abs(adv01 - clips01).max() <= EPS + 1e-5
    assert costs[-1] < costs[0]


@pytest.mark.parametrize("method", ["i2v", "ens"])
def test_attack_matches_jax(method):
    if method == "i2v":
        jb, pb = _both(["resnet"], 2)
        jatk = jattacks.ImageGuidedFMDirection_Adam(jb, step_size=0.01, epsilon=EPS,
                                                    steps=STEPS)
        patk = attacks.ImageGuidedFMDirection_Adam(pb, step_size=0.01, epsilon=EPS,
                                                   steps=STEPS)
    else:
        jb, pb = _both(ENS_NAMES, ENS_DEPTHS)
        jatk = jattacks.ImageGuidedFML2_Adam_MultiModels(jb, epsilon=EPS, steps=STEPS)
        patk = attacks.ImageGuidedFML2_Adam_MultiModels(pb, epsilon=EPS, steps=STEPS)
    clips01, videos = _clips(7)
    jatk(jnp.asarray(videos), jnp.asarray([0]), video_names=["v"])
    kernels.reset_launches()
    adv = patk(videos, np.asarray([0]), video_names=["v"])
    # CPU: the plain path
    assert kernels.launches == {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": 0}
    np.testing.assert_allclose(_costs(patk), _costs(jatk), rtol=2e-4)
    _check_invariants(adv, clips01, _costs(patk))
    assert str(patk).startswith(jatk.attack)


def test_ens_cost_gradient_matches_jax_at_generic_point():
    jb, pb = _both(ENS_NAMES, ENS_DEPTHS)
    rng = np.random.RandomState(3)
    frames01 = rng.rand(4, HW, HW, 3).astype(np.float32)
    modifier = (0.03 * np.sign(rng.randn(4, HW, HW, 3))).astype(np.float32)

    clean_j = [jax.lax.stop_gradient(t) for b in jb for t in b.apply01_taps(jnp.asarray(frames01))[1]]

    def cost_fn(mod):
        adv01 = pk.rebuild_adv(jnp.asarray(frames01), mod, EPS)
        return jlosses.i2v_cost([t for b in jb for t in b.apply01_taps(adv01)[1]], clean_j)

    g_jax = np.asarray(jax.grad(cost_fn)(jnp.asarray(modifier)))

    f = torch.from_numpy(frames01).permute(0, 3, 1, 2).contiguous()
    m = torch.from_numpy(modifier).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    with torch.no_grad():
        clean_t = [t for b in pb for t in b.apply01_taps(f)[1]]
    adv01 = kernels.rebuild_adv(f, m, EPS)
    losses.i2v_cost([t for b in pb for t in b.apply01_taps(adv01)[1]], clean_t).backward()
    g_port = m.grad.permute(0, 2, 3, 1).numpy()

    scale = np.abs(g_jax).max()
    assert scale > 0
    np.testing.assert_allclose(g_port, g_jax, atol=5e-4 * scale)


def test_cli_end_to_end_matches_jax_run_dir(tmp_path, monkeypatch):
    from i2v_tpu.cli import image_main as jimage_main
    from i2v_tpu_torch.cli import image_main

    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    argv = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--step", "2", "--tiny",
            "--data", "synthetic", "--n_synthetic", "2", "--batch_size", "1"]
    run_dir = image_main.main(argv + ["--device", "cpu"])
    assert run_dir == jimage_main.arg_parse(argv).adv_path
    assert os.path.basename(run_dir) == "Image-ImageGuidedFML2_Adam_MultiModels-2-synthetic"
    files = jartifacts.list_adv_files(run_dir)
    assert files == ["0-adv.npy", "1-adv.npy"]
    clips, labels = jartifacts.load_adv_batch(run_dir, files)
    assert clips.shape == (2, 3, 8, 32, 32) and clips.dtype == np.float32
    assert np.isfinite(clips).all() and labels.tolist() == [0, 1]
    with open(os.path.join(run_dir, "loss_info_1.json")) as f:
        info = json.load(f)
    assert sorted(info) == ["synthetic_0", "synthetic_1"]
    assert all(len(v) == 2 for v in info.values())


def test_cli_profile_writes_a_trace_and_times_each_call(tmp_path, monkeypatch):
    from i2v_tpu_torch.cli import image_main

    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    args = image_main.arg_parse(["--tiny", "--step", "1", "--n_synthetic", "2", "--device", "cpu",
                                 "--profile", str(tmp_path / "prof")])
    image_main.run(args)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    tp = args.throughput
    assert tp["calls"] == 2 and 0 < tp["last_call_s"] <= tp["elapsed_s"]


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    from i2v_tpu_torch.cli import image_main

    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        image_main.main(["--tiny", "--step", "1", "--n_synthetic", "1", "--device", "cuda"])
    assert not jartifacts.list_adv_files(
        os.path.join(tmp_path, "Image-ImageGuidedFMDirection_Adam-1-synthetic"))


@pytest.mark.parametrize("flags,item", [
    (["--model_parallel", "2"], "item 9"),
])
def test_cli_rejects_methods_not_ported_yet(tmp_path, monkeypatch, capsys, flags, item):
    """--model_parallel (ROADMAP item 9) is ported: it parses as the JAX
    CLI's does, and a run rejects it, with the JAX CLI's words, only for a
    method that has no surrogate ensemble to split or together with
    --sharded. The four methods are all accepted, and so are the other
    runner flags and the six surrogates."""
    from i2v_tpu.cli import common as jcommon
    from i2v_tpu.cli import image_main as jimage_main
    from i2v_tpu_torch.cli import common, image_main

    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    assert image_main.arg_parse(flags).model_parallel == \
        jimage_main.arg_parse(flags).model_parallel == 2
    assert "ROADMAP" not in capsys.readouterr().err
    for extra in (["--attack_method", "ImageGuidedFMDirection_Adam"],
                  ["--attack_method", "AENS_I2V_MF", "--sharded"]):
        with pytest.raises(SystemExit) as err:
            common.build_image_guided_attack(image_main.arg_parse(flags + extra + ["--tiny"]),
                                             torch.device("cpu"))
        with pytest.raises(SystemExit) as jerr:
            jcommon.build_image_guided_attack(jimage_main.arg_parse(flags + extra + ["--tiny"]))
        assert str(err.value) == str(jerr.value)
    for method in jimage_main.common.IMAGE_GUIDED_METHODS:
        assert image_main.arg_parse(["--attack_method", method]).attack_method == method
    ported = ["--sharded", "--frame_chunk", "auto", "--param_dtype", "bfloat16", "--multigrid",
              "12", "--multigrid_scale", "4"]
    assert vars(image_main.arg_parse(ported)).items() >= {
        "sharded": True, "frame_chunk": "auto", "param_dtype": "bfloat16", "multigrid": 12,
        "multigrid_scale": 4}.items()
    for name in ("resnet", "vgg", "alexnet", "squeezenet", "densenet", "vit"):
        argv = ["--direction_image_model", name]
        assert image_main.arg_parse(argv).direction_image_model == \
            jimage_main.arg_parse(argv).direction_image_model == name


@pytest.mark.parametrize("name,method,depth", [
    ("densenet", "ImageGuidedFMDirection_Adam", 3),
    ("vit", "ImageGuidedStd_Adam", 4),
])
def test_cli_runs_densenet_and_vit_like_the_jax_cli(tmp_path, monkeypatch, name, method, depth):
    """I2V on the tiny DenseNet and DR on the tiny ViT, one step through the
    port's ``cli.image_main`` and the JAX CLI's over the same clip, the JAX
    CLI handed the port's seeded surrogate (``to_jax_params``): the same
    (clamped) tap and the same step-0 cost."""
    from i2v_tpu.cli import common as jcommon
    from i2v_tpu.cli import image_main as jimage_main
    from i2v_tpu.models import ImageModel as JImageModel
    from i2v_tpu.models import registry as jregistry
    from i2v_tpu_torch.cli import image_main
    from i2v_tpu_torch.models import get_image_models
    from i2v_tpu_torch.models.convert import to_jax_params

    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path))
    seen = {}

    def jax_twins(names, depths, *, tiny, input_hw):
        (b,) = get_image_models(names, depths, device="cpu", tiny=tiny, input_hw=input_hw)
        module, taps = jregistry.build_image_model(b.name, depths, truncate=True, tiny=tiny)
        seen["taps"] = (taps, b.tap_keys)
        return [JImageModel(b.name, module, {"params": to_jax_params(b.module)}, taps)]

    monkeypatch.setattr(jcommon, "get_image_models", jax_twins)
    argv = ["--attack_method", method, "--direction_image_model", name, "--depth", str(depth),
            "--step", "1", "--tiny", "--n_synthetic", "1", "--clip_len", "4"]
    costs = []
    for run in (jimage_main.main(argv + ["--file_prefix", "jax"]),
                image_main.main(argv + ["--device", "cpu"])):
        assert jartifacts.list_adv_files(run) == ["0-adv.npy"]
        with open(os.path.join(run, "loss_info_1.json")) as f:
            costs.append(float(json.load(f)["synthetic_0"]["0"]["cost"]))
    taps, port_taps = seen["taps"]
    assert taps == port_taps == ((2,) if name == "densenet" else (1,))
    np.testing.assert_allclose(costs[1], costs[0], rtol=1e-5)


def _kinetics_sidecars(root, monkeypatch, n=2):
    """``n`` seeded uint8 (10, 256, 340, 3) sidecars at the decode size and
    their manifest, one clip with clip_index -1 and one seeded."""
    rows = ["path,gt_label,clip_index"]
    for v in range(n):
        np.save(os.path.join(root, f"vid{v}.npy"),
                np.random.RandomState(30 + v).randint(0, 256, (10, 256, 340, 3), np.uint8))
        rows.append(f"vid{v}.npy,{v},{2 * v - 1}")
    with open(os.path.join(root, "anno.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    monkeypatch.setenv("I2V_TPU_KINETICS_ANNO", os.path.join(root, "anno.csv"))
    monkeypatch.setenv("I2V_TPU_KINETICS_DATA", root)


def test_cli_kinetics_u8_prefetch_matches_jax_cli(tmp_path, monkeypatch):
    """ENS-I2V from Kinetics sidecars with --u8_ingress --prefetch 1: the
    costs match the JAX CLI's over the same clips and weights (the JAX CLI
    is handed the port's seeded surrogates through ``to_jax_params``), and
    the port's uint8 and float32 paths write the same bytes."""
    from i2v_tpu.cli import common as jcommon
    from i2v_tpu.cli import image_main as jimage_main
    from i2v_tpu.models import ImageModel as JImageModel
    from i2v_tpu.models import registry as jregistry
    from i2v_tpu_torch.cli import image_main
    from i2v_tpu_torch.models import get_image_models
    from i2v_tpu_torch.models.convert import to_jax_params

    monkeypatch.setenv("I2V_TPU_OPT_PATH", str(tmp_path / "out"))
    _kinetics_sidecars(str(tmp_path), monkeypatch)

    def jax_twins(names, depths, *, tiny, input_hw):
        ported = get_image_models(names, depths, device="cpu", tiny=tiny, input_hw=input_hw)
        out = []
        for b in ported:
            module, taps = jregistry.build_image_model(
                b.name, depths[b.name], truncate=True, tiny=tiny)
            out.append(JImageModel(b.name, module, {"params": to_jax_params(b.module)}, taps))
        return out

    monkeypatch.setattr(jcommon, "get_image_models", jax_twins)
    argv = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--step", "3", "--tiny",
            "--data", "kinetics", "--clip_len", "4", "--crop_size", "32"]
    fast = ["--u8_ingress", "--prefetch", "1"]
    jdir = jimage_main.main(argv + fast + ["--file_prefix", "jax"])
    u8dir = image_main.main(argv + fast + ["--device", "cpu"])
    f32dir = image_main.main(argv + ["--device", "cpu", "--file_prefix", "f32"])
    assert os.path.basename(u8dir) == "Image-ImageGuidedFML2_Adam_MultiModels-3-"
    runs = {}
    for key, d in (("jax", jdir), ("u8", u8dir), ("f32", f32dir)):
        assert jartifacts.list_adv_files(d) == ["0-adv.npy", "1-adv.npy"]
        with open(os.path.join(d, "loss_info_1.json")) as f:
            info = json.load(f)
        assert sorted(info) == ["vid0", "vid1"]
        runs[key] = (np.float32([[float(c[str(i)]["cost"]) for i in range(3)]
                                 for _, c in sorted(info.items())]),
                     jartifacts.load_adv_batch(d, ["0-adv.npy", "1-adv.npy"])[0])
    np.testing.assert_allclose(runs["u8"][0], runs["jax"][0], rtol=2e-4)
    np.testing.assert_array_equal(runs["u8"][0], runs["f32"][0])
    np.testing.assert_array_equal(runs["u8"][1], runs["f32"][1])
    assert runs["u8"][1].shape == (2, 3, 4, 32, 32)
    assert (runs["u8"][0][:, -1] < runs["u8"][0][:, 0]).all()
