"""Tracing / profiling utilities (SURVEY.md section 6, tracing row).

The reference had no first-party profiling (Theano flags only). Here:
  * ``trace(logdir)`` — context manager around ``jax.profiler.trace`` for
    device timeline capture (read with ``jax.profiler.ProfileData``).
  * ``annotate(name)`` — named region inside a trace.
  * ``StepTimer`` — wall-clock step rates fenced with
    ``jax.block_until_ready`` (JAX returns before the device finishes).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a profiler trace into ``logdir``. Profiler errors propagate:
    a trace that silently did not happen reads as an empty window."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named sub-region for traces: ``with annotate("scoring"): ...``"""
    return jax.profiler.TraceAnnotation(name)


class StepTimer:
    """Rolling steps/sec, fenced by ``block_until_ready`` on the value
    passed to :meth:`tick`.

    >>> timer = StepTimer()
    >>> for batch in batches:
    ...     state, metrics = step(state, batch)
    ...     rate = timer.tick(metrics)   # None until window fills
    """

    def __init__(self, window: int = 50):
        self._window = window
        self._count = 0
        self._t0: Optional[float] = None
        self.last_rate: Optional[float] = None

    def tick(self, fence_arg: Any = None) -> Optional[float]:
        self._count += 1
        if self._count % self._window:
            return None
        if fence_arg is not None:
            jax.block_until_ready(fence_arg)
        now = time.perf_counter()
        rate = None
        if self._t0 is not None:
            rate = self._window / (now - self._t0)
            self.last_rate = rate
        self._t0 = now
        return rate
