"""Memory budgets derived from the device the program runs on.

Chunking thresholds and host-side caches are sized as shares of the default
device's allocatable memory (``memory_stats()["bytes_limit"]``), so one
setting serves a small card and an 80 GB one alike. Backends that report no
limit (the CPU) count as ``FALLBACK_BYTES``, which keeps CPU runs and tests
deterministic.
"""

from __future__ import annotations

import functools
import os

import jax

__all__ = ["FALLBACK_BYTES", "device_memory_bytes", "memory_share", "msg_budget_bytes"]

FALLBACK_BYTES = 16 << 30


@functools.lru_cache(maxsize=None)
def device_memory_bytes() -> int:
    """Allocatable bytes of this process's first device (``FALLBACK_BYTES``
    if unknown). In a multi-process run ``jax.devices()[0]`` may belong to
    another process, whose memory cannot be queried."""
    stats = jax.local_devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit") or FALLBACK_BYTES)


def memory_share(share: float) -> float:
    """``share`` (0..1) of the default device's allocatable memory, in bytes."""
    return share * device_memory_bytes()


def msg_budget_bytes() -> float:
    """Largest (E, D) message tensor an SpMM materializes before it chunks:
    a quarter of device memory, or ``DGL_JAX_MSG_BUDGET_GB`` when set."""
    gb = os.environ.get("DGL_JAX_MSG_BUDGET_GB")
    if gb is not None:
        return float(gb) * (1 << 30)
    return memory_share(1 / 4)
