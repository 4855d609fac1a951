"""DIFGSM and the model-axis ensemble runner captured and replayed on a card.

The CPU tests (tests/test_torch_graphs_rest.py) hold these steps to their
eager forms; here, on a CUDA card, each runs eagerly (``graphs=False``) and
graphed: the graphs are captured (one a piece for DIFGSM; one a position and
one a slice's Adam for the ensemble), the kernels launch as often as the
eager twin's, the step-0 cost is the eager twin's bit for bit, and DIFGSM's
draw table is the host draws of its call's generator; a step graph's first
call records one ``setup.warm`` span, its second one ``setup.capture``
whose host seconds ``graphs.captures`` adds, its third neither. The file needs
neither JAX nor the JAX package, so that it runs on a machine with a card
(``python -m pytest --noconftest tests/test_torch_graphs_card.py -m gpu``);
without a card every test skips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.models import ImageModel, build_image_model, get_video_model  # noqa: E402
from i2v_tpu_torch.models.registry import random_init_  # noqa: E402
from i2v_tpu_torch.ops import diversity, kernels  # noqa: E402
from i2v_tpu_torch.parallel import ensemble  # noqa: E402
from i2v_tpu_torch.utils import graphs, profiling  # noqa: E402

HW, T = 32, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs are captured there only")
    return torch.device("cuda")


def _clips01(seed, b=2):
    return torch.from_numpy(np.random.RandomState(seed).rand(b, 3, T, HW, HW).astype(np.float32))


@pytest.mark.gpu
def test_difgsm_captures_and_replays_on_the_card(cuda):
    bundle = get_video_model("i3d_resnet50", device=cuda, tiny=True)
    clean = _clips01(20).to(cuda)
    labels = torch.tensor([1, 2], device=cuda)
    eager = attacks.DIFGSM(bundle, steps=4, graphs=False)._attack_pieces([clean], [labels],
                                                                          [cuda])
    before = graphs.captures["graphs"]
    kernels.reset_launches()
    atk = attacks.DIFGSM(bundle, steps=4)
    graphed = atk._attack_pieces([clean], [labels], [cuda])
    assert graphs.captures["graphs"] == before + 1
    assert kernels.launches["sign_step"] == 4
    assert float(graphed[1][0]) == float(eager[1][0])
    table = next(iter(atk._loops.values())).tables[0].table.cpu().numpy()
    np.testing.assert_array_equal(table, diversity.draw_table(
        torch.Generator().manual_seed(0), 4, *diversity.default_range(HW)))


@pytest.mark.gpu
def test_ensemble_captures_and_replays_on_the_card(cuda):
    models = []
    for i, name in enumerate(("resnet", "vgg")):
        module, taps = build_image_model(name, [1, 2], tiny=True, input_hw=HW)
        random_init_(module, torch.Generator().manual_seed(i))
        models.append(ImageModel(name, module.to(cuda).eval().requires_grad_(False), taps))
    mesh = ensemble.ensemble_mesh([cuda] * 4, model=2)
    clean = _clips01(21).to(cuda)
    eager = ensemble.make_ensemble_parallel_runner(models, mesh, steps=4, graphs=False)(clean)[1]
    before = graphs.captures["graphs"]
    kernels.reset_launches()
    graphed = ensemble.make_ensemble_parallel_runner(models, mesh, steps=4)(clean)[1]
    # a graph a position and one a slice's Adam
    assert graphs.captures["graphs"] == before + 6
    assert kernels.launches["rebuild_fwd"] == 4 * 4 + 2
    assert kernels.launches["rebuild_bwd"] == 4 * 4
    assert float(graphed[0]) == float(eager[0])
    np.testing.assert_allclose(graphed.cpu().numpy(), eager.cpu().numpy(), rtol=1e-4)


@pytest.mark.gpu
def test_a_step_graphs_warm_step_and_capture_are_one_off_spans(cuda):
    x = torch.ones(4096, device=cuda)

    def step():
        x.mul_(0.5).add_(1.0)

    graph = graphs.StepGraph(step, cuda)
    kernels.build_all()  # the capture builds them first in a process that has not
    profiling.reset_spans()

    def names():
        return [r.name for r in profiling.spans()]

    graph()
    assert names() == ["setup.warm"]
    before = graphs.captures["seconds"]
    graph()
    assert names() == ["setup.warm", "setup.capture"]
    capture = profiling.spans()[-1]
    assert capture.once and capture.outer is None and not capture.traced
    assert graphs.captures["seconds"] == before + capture.host_s
    graph()
    assert names() == ["setup.warm", "setup.capture"]
    torch.cuda.synchronize(cuda)
    assert float(x[0]) == 1.875  # 1 → 1.5 → 1.75 → 1.875: warm, capture's replay, replay
    profiling.reset_spans()
