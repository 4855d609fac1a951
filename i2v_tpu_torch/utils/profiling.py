"""Throughput meter, profiler trace and the program's spans.

  - :func:`trace`      — a ``torch.profiler`` trace (CPU and CUDA activity)
                         written as a Chrome trace into a directory, with the
                         spans of threads the profiler does not follow; a
                         no-op when no directory is given
  - :func:`span`       — a named interval of the program at a layer boundary,
                         recorded only while a profiler is on
  - :func:`spans`, :func:`span_totals`, :func:`reset_spans` — the finished
                         spans of the process
  - :func:`next_number` — a process-wide count (runner calls, evaluation
                         sweeps) that names one request's spans
  - :class:`StepTimer` — attack steps/s and clips/s; on a CUDA device it
                         synchronizes before reading the clock, since kernels
                         run asynchronously to the host

The switch is the profiler itself: with none running a span costs one
attribute read and records nothing. With one running, a span opens a
``record_function`` on its thread, so that on a profiled thread it is an
event of the trace beside the device's, and keeps a :class:`Span` in
memory, on ``time.time_ns()``, which is the exported trace's clock
(``ts`` · 1000 + ``baseTimeNanoseconds``). The profiler follows only the
threads it was started on: a worker thread's spans are absent from its
trace, and :func:`trace` writes them in from memory. Spans go around graph
replays and host work, never inside a captured step, which would record
them once, at capture.

The program's spans (a benchmark reads some of them by name):

  - a generation call (the runner of ``parallel/sharded.py``, the Adam
    engine of ``attacks/i2v.py``): ``i2v.call``, its unit the process's
    call number, over ``i2v.clean_taps`` (the frames copied in and their
    clean forward), ``i2v.steps`` and ``i2v.handback`` (the final rebuild
    and the copies handed back), each timed on the call's device too;
  - an evaluation call (``eval/transfer.py``): ``eval.sweep``, its unit the
    process's sweep number, over each batch's ``eval.ingest_wait`` (the
    loop's wait for the prefetch thread), ``eval.forward`` and
    ``eval.fetch`` (the host waiting for the predictions), and on the
    prefetch thread ``ingest.read``, ``ingest.pin`` and ``ingest.upload``,
    each batch's spans named ``(sweep, batch index)``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Optional

import torch


@dataclasses.dataclass
class Span:
    """One finished span. ``start_ns``/``end_ns`` are ``time.time_ns()``;
    ``parent`` is the name of the innermost span open on the same thread
    when it began; ``unit`` names the request it served (inherited from the
    parent unless given); ``traced``: its thread was profiled, so the trace
    holds it as a ``record_function`` event; ``device_ms``: the time between
    two CUDA events recorded at its ends on the device's current stream
    (None without a device)."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    unit: Any
    thread: str
    tid: int
    traced: bool
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


_records: list = []
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open spans
_numbers: dict = collections.defaultdict(itertools.count)
_OFF = contextlib.nullcontext()


class _Open:
    """An open span (profiler on): see :func:`span`."""

    def __init__(self, name: str, unit, device):
        self.name, self.unit = name, unit
        self.device = None if device is None else torch.device(device)
        self.annotation = None
        self.record: Optional[Span] = None

    def __enter__(self) -> Span:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        unit = self.unit if self.unit is not None or parent is None else parent.unit
        traced = torch.autograd._profiler_enabled()  # this thread's profiler
        if traced:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        # the host interval lies inside the annotation's and holds the events' records
        start_ns, events = time.time_ns(), None
        if self.device is not None and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record(torch.cuda.current_stream(self.device))
        thread = threading.current_thread()
        self.record = Span(self.name, start_ns, 0, None if parent is None else parent.name,
                           unit, thread.name, threading.get_native_id(), traced, events=events)
        stack.append(self.record)
        return self.record

    def __exit__(self, *exc) -> bool:
        rec = self.record
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(self.device))
        rec.end_ns = time.time_ns()
        _local.stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        with _lock:
            _records.append(rec)
        return False


def span(name: str, *, unit=None, device=None):
    """A context manager around one layer's work. With no profiler running
    (``torch.autograd.profiler._is_profiler_enabled``, set process-wide by
    any profiler) it does nothing. With one, it records a :class:`Span`;
    with ``device`` a CUDA device, also the device time between its ends on
    that device's current stream, read when :func:`spans` is called, after
    the caller has synchronized: the span itself never waits on the device."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, unit, device)


def spans() -> list:
    """The finished spans of the process, in the order they ended, their
    device times resolved (waiting for a span's end event if the device has
    not reached it yet)."""
    with _lock:
        for rec in _records:
            if rec.events is not None:
                start, end = rec.events
                end.synchronize()
                rec.device_ms, rec.events = start.elapsed_time(end), None
        return list(_records)


def span_totals(name: str) -> tuple:
    """→ (count, host seconds, device seconds) of the finished spans named
    ``name``; the device seconds are None where none of them was timed on a
    device."""
    mine = [r for r in spans() if r.name == name]
    timed = [r.device_ms for r in mine if r.device_ms is not None]
    return (len(mine), sum(r.host_s for r in mine),
            sum(timed) / 1e3 if timed else None)


def reset_spans() -> None:
    with _lock:
        _records.clear()


def next_number(kind: str) -> int:
    """0, 1, 2, … a call with the same ``kind`` in this process."""
    return next(_numbers[kind])


def _write_untraced_spans(path: str, since_ns: int) -> None:
    """Add to the Chrome trace at ``path`` the spans begun since
    ``since_ns`` on threads the profiler did not follow: complete events on
    their own thread, placed by the file's ``baseTimeNanoseconds``."""
    extra = [r for r in spans() if not r.traced and r.start_ns >= since_ns]
    if not extra:
        return
    with open(path) as f:
        doc = json.load(f)
    base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
    events = doc["traceEvents"]
    for tid, thread in sorted({(r.tid, r.thread) for r in extra}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": thread}})
    for r in extra:
        events.append({"ph": "X", "cat": "user_annotation", "name": r.name, "pid": pid,
                       "tid": r.tid, "ts": (r.start_ns - base) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": {"unit": r.unit, "parent": r.parent}})
    with open(path, "w") as f:
        json.dump(doc, f, default=str)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    since = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _write_untraced_spans(path, since)


class StepTimer:
    """Tracks attack throughput on one device: steps/sec and clips/sec.

    ``with timer(clips=len(batch)):`` records the actual clip count; the bare
    ``with timer:`` form uses ``clips_per_call``. A call whose body raises is
    not counted. ``last_call_s`` is the last call's time alone: after the
    first call it excludes one-time warm-up (CUDA context, cuDNN set-up).
    ``n_chips``: how many positions of a device mesh the timed runner spans;
    steps/s are reported per position, as the JAX timer reports them per
    chip. The host clock stops after ``device`` synchronizes: the runners
    gather their outputs there, so that waits for every card's share.
    """

    REPORT_EVERY = 5

    def __init__(self, steps_per_call: int, clips_per_call: int, device: torch.device | str,
                 n_chips: int = 1):
        self.steps_per_call = steps_per_call
        self.clips_per_call = clips_per_call
        self.device = torch.device(device)
        self.n_chips = max(1, n_chips)
        self.calls = 0
        self.clips = 0
        self.elapsed = 0.0
        self.last_call_s = 0.0
        self._t0: Optional[float] = None
        self._pending_clips: Optional[int] = None

    def __call__(self, clips: Optional[int] = None) -> "StepTimer":
        self._pending_clips = clips
        return self

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t0, self._t0 = self._t0, None
        clips, self._pending_clips = self._pending_clips, None
        if exc_type is not None:
            return  # a failed call contributes no throughput
        self._sync()
        self.last_call_s = time.perf_counter() - t0
        self.elapsed += self.last_call_s
        self.calls += 1
        self.clips += self.clips_per_call if clips is None else clips
        if self.calls % self.REPORT_EVERY == 0:
            print(f"[throughput] {self.steps_per_sec_per_chip:.2f} "
                     f"attack steps/s/chip, {self.clips_per_sec:.2f} adv clips/s")

    @property
    def steps_per_sec_per_chip(self) -> float:
        if not self.elapsed:
            return 0.0
        return self.calls * self.steps_per_call / self.elapsed / self.n_chips

    @property
    def clips_per_sec(self) -> float:
        if not self.elapsed:
            return 0.0
        return self.clips / self.elapsed

    def summary(self) -> dict:
        return {
            "attack_steps_per_sec_per_chip": self.steps_per_sec_per_chip,
            "adv_clips_per_sec": self.clips_per_sec,
            "n_chips": self.n_chips,
            "calls": self.calls,
            "elapsed_s": self.elapsed,
            "last_call_s": self.last_call_s,
        }
