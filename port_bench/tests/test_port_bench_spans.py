"""The readers of the program's spans and counter: each returns None where
the process recorded nothing, and its arithmetic on a hand-made table of
finished spans (``utils/profiling.spans``) and captures (``utils/graphs.captures``)."""

import pytest

from port_bench.harness import Bench, Context
from i2v_tpu_torch.utils import graphs, profiling

READERS = ("clean_taps_ms_per_call.gen", "ingest_wait_ms_per_batch.eval",
           "ingest_ms_per_batch.eval", "graph_capture_s.setup")
CTX = Context({}, {}, 1.0, 1.0, {"steps": 10, "batches": 4, "calls": 3}, 0, "cpu", {})


def _read(name):
    return Bench({}).module("metrics", name).read(CTX)


def _span(name, host_ms, device_ms=None, unit=0):
    return profiling.Span(name, 0, int(host_ms * 1e6), None, unit, "t", 1, True, device_ms)


TABLE = [
    # two runner calls: the clean taps' device ms sum to 90 over 2 calls
    _span("i2v.call", 900.0, 880.0, 0), _span("i2v.clean_taps", 50.0, 40.0, 0),
    _span("i2v.call", 900.0, 880.0, 1), _span("i2v.clean_taps", 60.0, 50.0, 1),
    # three batches: waits of 300, 10 and 20 ms; the worker's 100 + 5 + 15 a batch
    *[_span("eval.ingest_wait", ms, unit=(0, i)) for i, ms in enumerate((300.0, 10.0, 20.0))],
    *[_span(f"ingest.{part}", ms, unit=(0, i)) for i in range(3)
      for part, ms in (("read", 100.0), ("pin", 5.0), ("upload", 15.0))],
]


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_none(monkeypatch, name):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    monkeypatch.setattr(graphs, "captures", {"graphs": 0, "seconds": 0.0})
    assert _read(name) is None


@pytest.mark.parametrize("name, want", [
    ("clean_taps_ms_per_call.gen", 45.0),          # (40 + 50) / 2 calls, not the entry's 3
    ("ingest_wait_ms_per_batch.eval", 110.0),      # 330 / 3 waits
    ("ingest_ms_per_batch.eval", 120.0),           # (100 + 5 + 15) · 3 / 3 reads
    ("graph_capture_s.setup", 2.5),
])
def test_arithmetic_on_a_table(monkeypatch, name, want):
    monkeypatch.setattr(profiling, "spans", lambda: list(TABLE))
    monkeypatch.setattr(graphs, "captures", {"graphs": 5, "seconds": 2.5})
    assert _read(name) == pytest.approx(want)


def test_clean_taps_without_device_times_reads_none(monkeypatch):
    host_only = [_span("i2v.call", 900.0), _span("i2v.clean_taps", 50.0)]
    monkeypatch.setattr(profiling, "spans", lambda: host_only)
    assert _read("clean_taps_ms_per_call.gen") is None
