"""Timing utilities matching the reference's benchmark methodology.

Conventions preserved so numbers are comparable (SURVEY §5 tracing):
* epoch wallclock with warmup-skip (3 epochs full-graph
  ``main_dgl_citation_sage.py:211-222``; 5 for sampling
  ``ns-sage-dgl.py:181-182``),
* phase-split timers (load/forward/backward, ``cluster-sage/dgl/main.py:126-165``),
* op timers with cold-start skip (``kernel/utils.py:18-34``).

Async dispatch means wallclock must bracket ``block_until_ready``
(the analogue of the reference's ``th.cuda.synchronize``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import jax

__all__ = ["EpochTimer", "PhaseTimer", "op_time", "time_fn"]


class EpochTimer:
    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.durations: List[float] = []
        self._epoch = 0
        self._t0 = None

    def start(self):
        if self._epoch >= self.warmup:
            self._t0 = time.perf_counter()

    def stop(self, *sync_arrays):
        for a in sync_arrays:
            jax.block_until_ready(a)
        if self._t0 is not None:
            self.durations.append(time.perf_counter() - self._t0)
            self._t0 = None
        self._epoch += 1

    @property
    def mean(self) -> float:
        return sum(self.durations) / max(len(self.durations), 1)


class PhaseTimer:
    """Accumulate wallclock per named phase within an epoch loop."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str, *sync_on_exit):
        t0 = time.perf_counter()
        yield
        for a in sync_on_exit:
            jax.block_until_ready(a)
        self.totals[name] += time.perf_counter() - t0

    def summary(self) -> str:
        return ", ".join(f"{k}: {v:.4f}s" for k, v in self.totals.items())


@contextlib.contextmanager
def op_time(out: List[float]):
    """Context manager appending elapsed seconds (device-synced) to ``out``."""
    t0 = time.perf_counter()
    holder = {}
    yield holder
    if "result" in holder:
        jax.block_until_ready(holder["result"])
    out.append(time.perf_counter() - t0)


def time_fn(fn, *args, reps: int = 10, warmup: int = 2) -> float:
    """Average seconds per call, cold-start skipped (``kernel/dgl-new.py:18-23``)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps
