"""``tools/torch_perf_probe.py``'s counts, on the meta device: the FLOPs of
one runner step against the analytic count of the surrogates' conv layers
(forward plus input gradient, no weight gradient), the bytes of one aten op,
the data-sheet peaks and ``record``."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from tools import torch_perf_probe as probe  # noqa: E402

# GFLOP a 224² frame, forward plus input gradient, of each ENS surrogate to
# its tap: ResNet-101 to layer2, VGG-16 to features[20], SqueezeNet-1.1 to
# features[6], AlexNet to features[7]; 57.81 in all
PER_FRAME = {"resnet": 7_254_245_376, "vgg": 48_438_706_176, "squeezenet": 495_553_280,
             "alexnet": 1_625_463_552}


def test_full_width_ens_step_counts_the_analytic_conv_flops():
    models = probe.meta_models(probe.ENS_NAMES, probe.ENS_DEPTHS)
    for m in models:
        assert probe.analytic_conv_flops([m], 1) == PER_FRAME[m.name]
    per_frame = sum(PER_FRAME.values())
    assert round(per_frame / 1e9, 2) == 57.81
    step = probe.count_step(models, batch=1)
    assert step["flops_per_step"] == probe.analytic_conv_flops(models, 32) == 32 * per_frame
    assert set(step["flops_by_op"]) == {"aten.convolution", "aten.convolution_backward"}
    # the clean taps' forward, counted once outside the step, is the step's
    # forward; SqueezeNet's last expand1x1 feeds no tap, so it has no input
    # gradient
    fwd = step["flops_by_op"]["aten.convolution"]
    assert step["clean_tap_flops"] == fwd
    assert step["flops_by_op"]["aten.convolution_backward"] < fwd


@pytest.mark.parametrize("adaptive", [False, True])
def test_tiny_runner_step_counts_the_analytic_formula(adaptive):
    depths = probe.AENS_DEPTHS if adaptive else probe.ENS_DEPTHS
    models = probe.meta_models(probe.ENS_NAMES, depths, tiny=True)
    step = probe.count_step(models, batch=2, hw=64, frames=4, frame_chunk=4,
                            adaptive=adaptive)
    assert step["flops_per_step"] == probe.analytic_conv_flops(models, 8, hw=64) > 0
    # torch's own counter over each surrogate's forward and input gradient
    from torch.utils.flop_counter import FlopCounterMode

    total = 0
    for m in models:
        x = torch.empty(8, 3, 64, 64, device="meta", requires_grad=True)
        with FlopCounterMode(display=False) as counter:
            _, taps = m.apply01_taps(x)
            sum(t.sum() for t in taps).backward()
        total += counter.get_total_flops()
    assert step["flops_per_step"] == total


def test_bytes_of_one_add_are_its_three_tensors():
    a = torch.empty(3, 5, device="meta")
    b = torch.empty(3, 5, device="meta", dtype=torch.float64)
    with probe.OpCounter() as c:
        a.view(15)                              # a view moves nothing
        out = torch.add(a, b)
    assert out.dtype == torch.float64
    assert c.bytes == 15 * 4 + 15 * 8 + 15 * 8 and c.flops == 0


def test_peaks_are_the_data_sheets_and_an_unknown_card_raises():
    h100 = probe.peaks_for("NVIDIA H100 80GB HBM3")
    assert (h100["float32"], h100["tf32"], h100["bfloat16"], h100["hbm_bytes_per_s"]) == (
        67e12, 494.7e12, 989.4e12, 3.35e12)
    with pytest.raises(ValueError, match="no data-sheet peaks"):
        probe.peaks_for("NVIDIA A100-SXM4-80GB")


def test_record_writes_only_to_the_path_it_is_given(tmp_path):
    before = os.path.exists(probe.ARTIFACT) and os.path.getmtime(probe.ARTIFACT)
    path = tmp_path / "probe.json"
    probe.record("cost_a", {"mfu": 0.1}, str(path))
    probe.record("hbm_b", {"fits": False, "precision": "bfloat16"}, str(path))
    assert sorted(os.listdir(tmp_path)) == ["probe.json"]
    rows = json.loads(path.read_text())
    assert rows["cost_a"]["mfu"] == 0.1 and rows["hbm_b"]["fits"] is False
    assert rows["cost_a"]["card"] == {"device": "cpu"}
    assert rows["cost_a"]["torch"] == torch.__version__
    assert rows["cost_a"]["precision"].startswith("cudnn.allow_tf32=")
    assert rows["hbm_b"]["precision"] == "bfloat16"
    assert (os.path.exists(probe.ARTIFACT) and os.path.getmtime(probe.ARTIFACT)) == before


@pytest.mark.parametrize("argv", [["cost", "ens16_bf16"], ["hbm", "mi16"],
                                  ["cost", "ens16_bf16", "--device", "cpu"]])
def test_the_probe_exits_without_a_card(argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="none is available"):
        probe.main(argv + ["--out", str(tmp_path / "p.json")])
    assert not os.listdir(tmp_path)


def test_an_unknown_case_is_refused():
    with pytest.raises(SystemExit, match="unknown cost case 'ens99'"):
        probe.main(["cost", "ens99"])
