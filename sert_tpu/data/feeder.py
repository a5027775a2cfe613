"""Device feed: double-buffered host->device batch pipeline.

The reference overlapped multiprocessing batch construction with Theano
device compute (SURVEY.md section 4.2). The equivalent here: a small
background thread stages the next host batch onto the device (optionally with
an explicit ``NamedSharding`` for data-parallel meshes) while the current
step runs — JAX dispatch is async, so depth-2 prefetch suffices to keep the
chip busy.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import jax


class PrefetchFeeder:
    """Wrap a host batch iterator; yields device-resident batches.

    ``put_fn`` maps a host batch to device arrays (default ``jax.device_put``;
    pass a sharded put for pjit meshes). Exceptions in the worker propagate to
    the consumer. ``deterministic=True`` bypasses the thread entirely (test
    mode, SURVEY.md section 6 "race detection").

    Shutdown contract: if the consumer stops early (exception in the train
    step, break), call :meth:`close` — or use the feeder as a context
    manager — so the worker thread stops instead of blocking forever on a
    full queue while pinning device-resident batches. The worker's queue
    puts poll a stop flag, so close() returns promptly.
    """

    _SENTINEL = object()

    def __init__(
        self,
        batches: Iterator[Any],
        put_fn: Optional[Callable[[Any], Any]] = None,
        depth: int = 2,
        deterministic: bool = False,
    ):
        self._batches = batches
        self._put = put_fn if put_fn is not None else jax.device_put
        self._deterministic = deterministic
        if not deterministic:
            self._q: queue.Queue = queue.Queue(maxsize=depth)
            self._err: Optional[BaseException] = None
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _put_or_stop(self, item) -> bool:
        """Blocking put that gives up when close() is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            for b in self._batches:
                if self._stop.is_set() or not self._put_or_stop(self._put(b)):
                    return
        except BaseException as e:  # propagate to consumer
            self._err = e
        finally:
            self._put_or_stop(self._SENTINEL)

    def close(self) -> None:
        """Stop the worker and drain staged batches (releases their device
        buffers). Idempotent; no-op in deterministic mode."""
        if self._deterministic:
            return
        self._finished = True   # any later __iter__ must not block
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "PrefetchFeeder":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __iter__(self) -> Iterator[Any]:
        if self._deterministic:
            for b in self._batches:
                yield self._put(b)
            return
        if getattr(self, "_finished", False):
            # One-shot, like any generator over an exhausted source: a
            # second iteration would block forever on a queue the dead
            # worker will never feed.
            raise RuntimeError(
                "PrefetchFeeder is exhausted; construct a new one per epoch")
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                self._finished = True
                if self._err is not None:
                    raise self._err
                return
            yield item
