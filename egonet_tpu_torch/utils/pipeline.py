"""Producer-thread prefetch with exception propagation (port of
``egonet_tpu/utils/pipeline.py``): an exception raised while preparing item
k is re-raised in the consumer at position k instead of silently
truncating the stream.  The producer's hand-over of each item is the
``queue_put`` span (``utils/profiling.PIPELINE_SPANS``): the time it sat
ahead of the consumer with nothing to do."""

from __future__ import annotations

import queue as queue_mod
import threading

from egonet_tpu_torch.utils.profiling import span


class _Raise:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_map(fn, iterable, depth: int = 2):
    """Yield ``fn(item)`` for each item, computed ``depth`` ahead in a
    background thread.  ``fn=None`` yields items unchanged.

    Abandoning the generator early (break / GC) stops the producer, so the
    thread never parks forever on a full queue holding the last item.
    """
    q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if stop.is_set():
                    return
                out = fn(item) if fn is not None else item
                with span("queue_put"):
                    handed = put(out)
                if not handed:
                    return
        except BaseException as exc:  # noqa: BLE001 — re-raised in consumer
            put(_Raise(exc))
        finally:
            put(sentinel)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, _Raise):
                raise item.exc
            yield item
    finally:
        stop.set()
