"""``tools/torch_baseline_anchor.py``: the reference's hook-tap ENS and AENS
steps (``tools/torch_surrogates.py``'s full networks, ``F.cosine_similarity``,
``torch.optim.Adam``) against the port's runner over the same weights, the
surrogates' state_dicts through ``convert_torchvision``. On the CPU in
float32 at 64², two frames: the step-0 cost, the modifier gradient at a
generic modifier (away from the clamp ties) and the first three Adam steps'
costs.

The VGG-16 and AlexNet heads are narrowed to 8 units here: the taps sit in
``features``, the heads' outputs are thrown away by both sides, and their
full 25088x4096 and 9216x4096 layers would spend most of the file's time
writing and reading checkpoint bytes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu_torch.ops import pixel  # noqa: E402
from tools import torch_baseline_anchor as anchor  # noqa: E402

HW, FRAMES = 64, 2
COST_RTOL = 1e-5          # the tool's gate
GRAD_ATOL = 1e-5          # times max|g|
STEPS = 3


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(reference models, {method: port models with their weights})."""
    mdls = anchor.torch_models("cpu")
    torch.manual_seed(1)
    nn = torch.nn
    mdls["vgg"].classifier = nn.Sequential(
        nn.Linear(512 * 7 * 7, 8), nn.ReLU(True), nn.Dropout(), nn.Linear(8, 8), nn.ReLU(True),
        nn.Dropout(), nn.Linear(8, 1000)).eval().requires_grad_(False)
    mdls["alexnet"].classifier = nn.Sequential(
        nn.Dropout(), nn.Linear(256 * 6 * 6, 8), nn.ReLU(True), nn.Dropout(), nn.Linear(8, 8),
        nn.ReLU(True), nn.Linear(8, 1000)).eval().requires_grad_(False)
    ckpts = str(tmp_path_factory.mktemp("ckpts"))
    anchor.convert_weights(mdls, ckpts)
    ports = {"ens": anchor.port_models(anchor.ENS_DEPTHS, "cpu", ckpts, hw=HW),
             "aens": anchor.port_models(anchor.AENS_DEPTHS, "cpu", ckpts, hw=HW)}
    return mdls, ports


def _clip01():
    rng = np.random.RandomState(3)
    return torch.from_numpy((0.1 + 0.8 * rng.rand(1, 3, FRAMES, HW, HW)).astype(np.float32))


def _generic_modifier(frames01):
    """Uniform in ±2ε, kept 1e-4 away from ±ε, where the clamp's gradient ties."""
    rng = np.random.RandomState(4)
    m = rng.uniform(-2 * anchor.EPS, 2 * anchor.EPS, frames01.shape).astype(np.float32)
    near = np.abs(np.abs(m) - anchor.EPS) < 1e-4
    m[near] *= 0.5
    return torch.from_numpy(m)


@pytest.mark.parametrize("method", ["ens", "aens"])
def test_step0_cost_is_the_references(sides, method):
    mdls, ports = sides
    clip01 = _clip01()
    frames01 = pixel.flatten_clip_to_frames(clip01)
    step, _, remove = anchor.reference_attack(mdls, frames01, method == "aens")
    try:
        ref = float(step())
    finally:
        remove()
    runner = anchor.port_runner(ports[method], 1, method == "aens")
    port, _ = runner.value_and_grad(clip01, torch.full_like(frames01, anchor.MODIFIER_INIT))
    assert abs(float(port) - ref) <= COST_RTOL * abs(ref), (float(port), ref)


@pytest.mark.parametrize("method", ["ens", "aens"])
def test_modifier_gradient_is_the_references(sides, method):
    mdls, ports = sides
    clip01 = _clip01()
    frames01 = pixel.flatten_clip_to_frames(clip01)
    mod = _generic_modifier(frames01)
    step, modifier, remove = anchor.reference_attack(mdls, frames01, method == "aens", mod)
    try:
        ref_cost = float(step())
    finally:
        remove()
    ref_g = modifier.grad
    cost, g = anchor.port_runner(ports[method], 1, method == "aens").value_and_grad(clip01, mod)
    assert abs(float(cost) - ref_cost) <= COST_RTOL * abs(ref_cost)
    scale = float(ref_g.abs().max())
    assert scale > 0
    err = float((g - ref_g).abs().max())
    assert err <= GRAD_ATOL * scale, (err, scale)


@pytest.mark.parametrize("method", ["ens", "aens"])
def test_three_adam_steps_are_the_references(sides, method):
    mdls, ports = sides
    clip01 = _clip01()
    step, _, remove = anchor.reference_attack(mdls, pixel.flatten_clip_to_frames(clip01),
                                              method == "aens")
    try:
        ref = np.asarray([float(step()) for _ in range(STEPS)])
    finally:
        remove()
    _, costs = anchor.port_runner(ports[method], STEPS, method == "aens")(clip01)
    costs = costs.numpy().astype(np.float64)
    np.testing.assert_allclose(costs, ref, rtol=COST_RTOL, atol=0)
    assert costs[-1] < costs[0]


def test_reference_counts_more_flops_than_the_truncated_port():
    flops = anchor.counted_flops(1, 224, adaptive=False)
    # the reference's forwards run past the taps; both take the same input gradients
    assert 1.3 < flops["reference"] / flops["port"] < 1.4
    assert flops["port"] == 32 * 57_813_968_384


def test_the_anchor_exits_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="none is available"):
        anchor.main(["--out", str(tmp_path / "anchor.json")])
    assert not list(tmp_path.iterdir())
