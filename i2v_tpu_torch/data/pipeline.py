"""Host→device prefetch pipeline.

PyTorch counterpart of :mod:`i2v_tpu.data.pipeline`. The reference leans on 9
DataLoader fork-workers (datasets.py:272-274); here a worker thread decodes
ahead of the device through a bounded queue (:func:`threaded_prefetch`), and
:func:`device_prefetch` starts each batch's upload early, from pinned memory
on a side stream, so that decode and the host-to-device copy overlap the
attack. Over a device mesh each batch lands as its per-device pieces, laid
out by the mesh's clip sharding (``i2v_tpu/cli/common.py:128-137``): no
batch goes whole to one card only to be cut up there.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import Sharded, clip_sharding


def threaded_prefetch(make_iter: Callable[[], Iterator], depth: int = 1) -> Iterator:
    """Run ``make_iter()`` in a worker thread, at most ``depth`` items ahead
    of the consumer (a B=16 evaluation batch is 308 MB, on the device once
    uploaded).

    An exception in the worker is raised again in the consumer. The worker's
    puts poll a stop event, so that a consumer that stops early (an error in
    its loop, a ``break``) lets the thread exit instead of pinning a batch
    for the life of the process: the generator's ``finally`` (run on close
    or garbage collection) sets it."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in make_iter():
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


class _Upload:
    """One batch's clips on their way to the device: pinned host memory,
    copied without blocking on a side stream. The pinned tensor is held
    until the consumer takes the batch; after that the caching host
    allocator keeps its block from reuse until the copy's recorded event
    has passed."""

    def __init__(self, clips: np.ndarray, device: torch.device,
                 stream: Optional["torch.cuda.Stream"]):
        host = torch.from_numpy(np.ascontiguousarray(clips))
        self.stream = stream
        if stream is None:
            self.clips = host.to(device)
            return
        self.host = host.pin_memory()
        with torch.cuda.stream(stream):
            self.clips = self.host.to(device, non_blocking=True)
            # this copy's own event: waiting on the whole side stream would
            # also wait for the later batches' copies queued behind it
            self.copied = torch.cuda.Event()
            self.copied.record(stream)

    def take(self) -> torch.Tensor:
        """The device clips, ordered after the copy on the consumer's stream."""
        if self.stream is not None:
            consumer = torch.cuda.current_stream(self.clips.device)
            consumer.wait_event(self.copied)
            # the clips were allocated on the side stream: tell the caching
            # allocator that the consumer's stream uses them too
            self.clips.record_stream(consumer)
            self.host = None
        return self.clips


class _ShardedUpload:
    """One batch's clips on their way to a mesh, laid out by its clip
    sharding: one :class:`_Upload` a distinct (piece, device)."""

    def __init__(self, clips: np.ndarray, mesh, streams: dict):
        self.sharding = clip_sharding(mesh)
        per = len(clips) // self.sharding.n_pieces
        uploads: dict = {}
        self.uploads = []
        for piece, dev in zip(self.sharding.piece_of(), mesh.positions):
            if (piece, dev) not in uploads:
                uploads[piece, dev] = _Upload(clips[piece * per:(piece + 1) * per], dev,
                                              streams[dev])
            self.uploads.append(uploads[piece, dev])

    def take(self) -> Sharded:
        taken: dict = {}
        for u in self.uploads:
            if id(u) not in taken:
                taken[id(u)] = u.take()
        return Sharded(self.sharding, [taken[id(u)] for u in self.uploads])


def _divides(clips: np.ndarray, mesh) -> bool:
    """Whether the batch lays out over the mesh: B over its data axis and
    B·T over all its positions (a trailing batch may not; it lands whole on
    the first device and the attack pads it)."""
    b = clips.shape[0]
    t = clips.shape[1] if clips.dtype == np.uint8 else clips.shape[2]
    return b % mesh.shape["data"] == 0 and (b * t) % mesh.size == 0


def device_prefetch(batches: Iterator[dict], device: torch.device | str, depth: int = 2,
                    keep_host: bool = False, mesh=None) -> Iterator[dict]:
    """Move 'clips' to ``device`` ahead of consumption; with a ``mesh``, to
    its devices as the pieces of its clip sharding (a
    :class:`~i2v_tpu_torch.parallel.mesh.Sharded`), or whole to its first
    device where the batch does not divide over it.

    At most ``depth`` batches are resident beyond the one handed to the
    consumer (depth=2: double-buffered ahead of the batch in use; a B=16 f32
    clip batch is 308 MB of device memory, 77 MB in uint8, so an off-by-one
    here is real memory). 'labels' stay on the host: the consumers name
    artifacts and report rows by them, and the attacks upload them anyway.

    ``keep_host=True`` keeps the host array under ``clips_host``, so that a
    consumer that writes the clean clips (``cli.attack``'s ``-ori``) reads
    the host copy instead of pulling the clips back from the device."""
    devices = [torch.device(device)] if mesh is None else mesh.distinct_devices
    streams = {d: torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices}
    buf: list[tuple[dict, _Upload]] = []

    def put(b):
        out = dict(b)
        if keep_host:
            out["clips_host"] = b["clips"]
        if mesh is not None and _divides(b["clips"], mesh):
            return out, _ShardedUpload(b["clips"], mesh, streams)
        return out, _Upload(b["clips"], devices[0], streams[devices[0]])

    def take(entry):
        out, upload = entry
        out["clips"] = upload.take()
        return out

    for b in batches:
        buf.append(put(b))
        if len(buf) >= depth:
            yield take(buf.pop(0))
    for entry in buf:
        yield take(entry)


def make_input_pipeline(dataset, batch_size: int, iterate, *, left: int = 0,
                        right: Optional[int] = None, device: torch.device | str = "cuda",
                        prefetch_depth: int = 2, keep_host: bool = False,
                        mesh=None) -> Iterator[dict]:
    """Decode thread → bounded queue → device upload (over ``mesh``, as its
    clip sharding's pieces), composed."""
    host = threaded_prefetch(lambda: iterate(dataset, batch_size, left, right),
                             prefetch_depth)
    return device_prefetch(host, device, prefetch_depth, keep_host=keep_host, mesh=mesh)
