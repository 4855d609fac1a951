"""The port's spans (``i2v_tpu_torch.utils.profiling.span``) on the CPU.

Held here:
  - with no profiler running a span records nothing and opens no
    ``record_function``; with one, it records its name, parent, unit and
    thread, nests, and a worker thread's spans are kept in memory (the
    profiler does not follow that thread);
  - a runner call (``make_sharded_i2v_runner``, a fresh call and a resumed
    one) and an Adam-engine call each give one ``i2v.call`` with one
    ``i2v.clean_taps``, ``i2v.steps`` and ``i2v.handback`` under it;
  - ``single_pass_eval`` over three batches gives three ``eval.ingest_wait``
    and three of each ``ingest.*``, named by ``(sweep, batch)``, and its
    logged ``data_time`` is the wait the span measured;
  - ``profiling.trace()``'s ``trace.json`` holds the main thread's spans and
    the worker's, the worker's inside their ``eval.sweep``;
  - the runner's and the engine's outputs are the same, bit for bit, with
    the profiler on and off.
"""

import json
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread, torch_rng_restored  # noqa: E402,F401

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from i2v_tpu_torch import attacks  # noqa: E402
from i2v_tpu_torch.eval import transfer  # noqa: E402
from i2v_tpu_torch.models import ImageModel, build_image_model, get_video_model  # noqa: E402
from i2v_tpu_torch.models.registry import random_init_  # noqa: E402
from i2v_tpu_torch.ops import pixel  # noqa: E402
from i2v_tpu_torch.parallel import sharded  # noqa: E402
from i2v_tpu_torch.utils import artifacts, profiling  # noqa: E402

HW, T, STEPS = 32, 4, 2
CALL_SPANS = ("i2v.clean_taps", "i2v.steps", "i2v.handback")


@pytest.fixture(autouse=True)
def _no_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def models():
    module, taps = build_image_model("resnet", 2, tiny=True, input_hw=HW)
    random_init_(module, torch.Generator().manual_seed(0))
    return [ImageModel("resnet", module.eval().requires_grad_(False), taps)]


def _clips01(seed, b=2, t=T):
    return torch.from_numpy(np.random.RandomState(seed).rand(b, 3, t, HW, HW).astype(np.float32))


def _by_name(name):
    return [r for r in profiling.spans() if r.name == name]


# -- the facility -----------------------------------------------------------------------

def test_off_records_nothing_and_opens_no_annotation(monkeypatch):
    def refuse(*_):
        raise AssertionError("record_function opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.span("a", unit=1, device="cpu") as got:
        with profiling.span("b"):
            pass
    assert got is None
    assert profiling.spans() == [] and profiling.span_totals("a") == (0, 0.0, None)


def test_on_records_name_parent_unit_and_thread_and_nests():
    with _profiled():
        with profiling.span("outer", unit=7):
            with profiling.span("inner"):
                pass
            with profiling.span("other", unit=8):
                pass
    inner, other, outer = profiling.spans()   # in the order they ended
    assert [r.name for r in (inner, other, outer)] == ["inner", "other", "outer"]
    assert (outer.parent, inner.parent, other.parent) == (None, "outer", "outer")
    assert (outer.unit, inner.unit, other.unit) == (7, 7, 8)
    assert {r.thread for r in (inner, other, outer)} == {threading.current_thread().name}
    assert all(r.traced and r.device_ms is None for r in (inner, other, outer))
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= other.start_ns \
        <= other.end_ns <= outer.end_ns
    count, host_s, device_s = profiling.span_totals("outer")
    assert (count, device_s) == (1, None) and host_s == pytest.approx(outer.host_s)
    profiling.reset_spans()
    assert profiling.spans() == []


def test_a_worker_threads_spans_are_kept_in_memory():
    def work():
        with profiling.span("job", unit=(3, 1)):
            with profiling.span("step"):
                pass

    with _profiled():
        with profiling.span("main"):
            t = threading.Thread(target=work, name="helper")
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    step, job, main = profiling.spans()
    assert (job.thread, step.thread, main.thread) == ("helper", "helper",
                                                    threading.current_thread().name)
    # the worker's stack is its own: its outermost span has no parent
    assert (job.parent, step.parent, step.unit) == (None, "job", (3, 1))
    assert not job.traced and not step.traced and main.traced
    assert job.tid != main.tid


# -- the spans of a generation call -----------------------------------------------------

def _runner_calls(models):
    runner = sharded.make_sharded_i2v_runner(models, steps=STEPS, frame_chunk=4,
                                             return_modifier=True, opt_state_io=True)
    clean = _clips01(3)
    first = runner(clean)
    second = runner(clean, mod_init=first[2], opt_init=first[3])
    return first + second


def _engine_calls(models):
    atk = attacks.ImageGuidedFML2_Adam_MultiModels(models, steps=STEPS)
    return atk._run(_clips01(4))[:2] + atk._run(_clips01(5))[:2]


CALLS = {"runner": _runner_calls, "engine": _engine_calls}


@pytest.mark.parametrize("path", sorted(CALLS))
def test_each_call_has_one_of_each_phase_under_it(models, path):
    with _profiled():
        CALLS[path](models)
    calls = _by_name("i2v.call")
    assert len(calls) == 2 and calls[0].unit != calls[1].unit
    for call in calls:
        assert call.parent is None and isinstance(call.unit, int)
        for name in CALL_SPANS:
            (child,) = [r for r in _by_name(name) if r.unit == call.unit]
            assert child.parent == "i2v.call"
            assert call.start_ns <= child.start_ns <= child.end_ns <= call.end_ns
    assert all(len(_by_name(name)) == 2 for name in CALL_SPANS)
    # the phases in order: taps, steps, hand-back
    for unit in (c.unit for c in calls):
        starts = [next(r for r in _by_name(n) if r.unit == unit).start_ns for n in CALL_SPANS]
        assert starts == sorted(starts)


@pytest.mark.parametrize("path", sorted(CALLS))
def test_outputs_are_the_same_with_the_profiler_on_and_off(models, path):
    off = CALLS[path](models)
    with _profiled():
        on = CALLS[path](models)
    assert profiling.span_totals("i2v.call")[0] == 2
    flat = [(a, b) for x, y in zip(off, on)
            for a, b in (zip(x, y) if isinstance(x, tuple) else [(x, y)])]
    for a, b in flat:
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# -- the spans of an evaluation sweep ----------------------------------------------------

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("artifacts"))
    for label in range(3):
        clip = pixel.normalize(_clips01(10 + label, b=1, t=8), channel_axis=1)[0]
        artifacts.save_adv_clip(path, label, np.asarray(clip))
    return path


def _sweep(run_dir, log=lambda *_: None):
    bundles = {"i3d_resnet50": get_video_model("i3d_resnet50", device="cpu", tiny=True)}
    batches = artifacts.batch_files(artifacts.list_adv_files(run_dir), 1)
    return transfer.single_pass_eval(bundles, batches, run_dir, log=log)


def test_a_sweep_names_each_batchs_wait_and_ingest(run_dir):
    logged = []
    with _profiled():
        _sweep(run_dir, log=logged.append)
    (sweep,) = _by_name("eval.sweep")
    units = {(sweep.unit, i) for i in range(3)}
    for name in ("eval.ingest_wait", "eval.forward", "eval.fetch",
                 "ingest.read", "ingest.pin", "ingest.upload"):
        got = _by_name(name)
        assert len(got) == 3 and {r.unit for r in got} == units, name
    assert all(r.parent == "eval.sweep" for r in _by_name("eval.ingest_wait"))
    assert all(r.thread == "prefetch" and not r.traced
               for r in profiling.spans() if r.name.startswith("ingest."))
    # the log's data_time of batch 0 is the wait that batch's span measured
    (data_time,) = [float(m) for line in logged
                    for m in re.findall(r"data_time: ([0-9.]+)", line)]
    wait0 = next(r for r in _by_name("eval.ingest_wait") if r.unit == (sweep.unit, 0))
    assert data_time == pytest.approx(wait0.host_s, abs=2e-3)


def test_the_trace_file_holds_the_main_threads_spans_and_the_workers(run_dir, tmp_path):
    with profiling.trace(str(tmp_path)):
        _sweep(run_dir)
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (sweep,) = [e for e in events if e["name"] == "eval.sweep"]
    waits = [e for e in events if e["name"] == "eval.ingest_wait"]
    assert len(waits) == 3 and all(e["tid"] == sweep["tid"] for e in waits)
    for name in ("ingest.read", "ingest.pin", "ingest.upload"):
        worker = [e for e in events if e["name"] == name]
        assert len(worker) == 3, name
        for e in worker:
            assert e["tid"] != sweep["tid"]
            assert sweep["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= sweep["ts"] + sweep["dur"]
