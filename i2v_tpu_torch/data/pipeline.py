"""Host→device prefetch thread.

PyTorch counterpart of ``i2v_tpu.data.pipeline.threaded_prefetch``: a worker
thread runs a batch iterator ahead of the consumer through a bounded queue,
so that reading the next batch from disk (and its upload, when the iterator
issues one) overlaps the consumer's device work.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


def threaded_prefetch(make_iter: Callable[[], Iterator]) -> Iterator:
    """Run ``make_iter()`` in a worker thread, at most one item ahead of the
    consumer (a B=16 evaluation batch is 308 MB, on the device once
    uploaded).

    An exception in the worker is raised again in the consumer. The worker's
    puts poll a stop event, so that a consumer that stops early (an error in
    its loop, a ``break``) lets the thread exit instead of pinning a batch
    for the life of the process: the generator's ``finally`` (run on close
    or garbage collection) sets it."""
    q: queue.Queue = queue.Queue(maxsize=1)
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
