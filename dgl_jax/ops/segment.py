"""Segment reductions — the scalar core of message passing.

Everything in this framework reduces to "gather rows, combine, reduce by
segment id". These wrappers centralise the conventions:

* ``num_segments`` is always static (XLA requirement),
* out-of-range indices (our padding sentinel) are *dropped* by the scatter,
* canonical edge order is dst-sorted so ``indices_are_sorted=True`` is safe.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp

__all__ = [
    "use_scan_reductions",
    "segment_sum_sorted_scan",
    "segment_sum_blocked",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax_denom",
    "segment_count",
]


def use_scan_reductions() -> bool:
    """Single gate for the scan-based (cumsum) formulations of sorted edge
    reductions and spreads. ``DGL_JAX_SEGSUM=cumsum`` selects them; ``auto``
    (the default) and ``scatter`` use the sorted scatter-add and the row
    gather on every backend.

    Numerics: a whole-array prefix difference carries error proportional
    to ulp(prefix magnitude), so it is not exactness-grade; the blocked
    formulation (``segment_sum_blocked``) keeps prefixes block-local and
    reaches scatter-grade error. One-time precomputes force the scatter."""
    return os.environ.get("DGL_JAX_SEGSUM", "auto") == "cumsum"


def segment_sum_sorted_scan(msg, indptr):
    """Sorted segment sum over edges via prefix-scan + indptr-diff
    ((E_pad, ...) → (N, ...))."""
    z = jnp.cumsum(msg, axis=0, dtype=msg.dtype)
    z = jnp.concatenate([jnp.zeros((1,) + msg.shape[1:], msg.dtype), z], axis=0)
    ends = jnp.take(z, indptr, axis=0)
    return ends[1:] - ends[:-1]


def segment_sum_blocked(msg, segblocks, num_segments: int):
    """Sorted segment sum with scatter-grade accuracy at near-scan speed.

    Block-LOCAL inclusive prefixes (magnitudes bounded by 128-edge block
    content, so no prefix-magnitude ulp growth) are combined per
    (segment × block) piece and scatter-added over the small piece set
    (≈ N + E/128 items instead of E).
    """
    seg_id, idx_end, idx_sub = segblocks
    e_pad = msg.shape[0]
    from ..graph.graph import SEG_BLOCK

    local = jnp.cumsum(
        msg.reshape((e_pad // SEG_BLOCK, SEG_BLOCK) + msg.shape[1:]), axis=1,
        dtype=msg.dtype,
    ).reshape(msg.shape)
    ext = jnp.concatenate([local, jnp.zeros((1,) + msg.shape[1:], msg.dtype)], axis=0)
    pieces = jnp.take(ext, idx_end, axis=0) - jnp.take(ext, idx_sub, axis=0)
    return jax.ops.segment_sum(
        pieces, seg_id, num_segments=num_segments, indices_are_sorted=True
    )


def segment_sum(data, segment_ids, num_segments: int, *, sorted: bool = False):
    return jax.ops.segment_sum(
        data, segment_ids, num_segments=num_segments, indices_are_sorted=sorted
    )


def segment_count(segment_ids, num_segments: int, *, sorted: bool = False, dtype=jnp.int32):
    ones = jnp.ones(segment_ids.shape, dtype=dtype)
    return segment_sum(ones, segment_ids, num_segments, sorted=sorted)


def segment_mean(data, segment_ids, num_segments: int, *, sorted: bool = False):
    """Mean with empty-segment → 0 (DGL ``fn.mean`` zero-in-degree semantics,
    see reference ``main_dgl_citation_sage.py:75-77``)."""
    s = segment_sum(data, segment_ids, num_segments, sorted=sorted)
    n = segment_count(segment_ids, num_segments, sorted=sorted, dtype=s.dtype)
    n = jnp.maximum(n, 1)
    return s / n.reshape(n.shape + (1,) * (s.ndim - n.ndim))


def segment_max(data, segment_ids, num_segments: int, *, sorted: bool = False, empty_value=0.0):
    """Max with empty-segment → ``empty_value`` (DGL semantics: 0)."""
    m = jax.ops.segment_max(
        data, segment_ids, num_segments=num_segments, indices_are_sorted=sorted
    )
    return jnp.where(jnp.isfinite(m), m, jnp.asarray(empty_value, dtype=m.dtype))


def segment_min(data, segment_ids, num_segments: int, *, sorted: bool = False, empty_value=0.0):
    m = jax.ops.segment_min(
        data, segment_ids, num_segments=num_segments, indices_are_sorted=sorted
    )
    return jnp.where(jnp.isfinite(m), m, jnp.asarray(empty_value, dtype=m.dtype))


def segment_softmax_denom(z, segment_ids, num_segments: int, *, sorted: bool = False):
    """Sum of exponentials per segment, gathered back to elements."""
    denom = segment_sum(z, segment_ids, num_segments, sorted=sorted)
    return jnp.take(denom, jnp.minimum(segment_ids, num_segments - 1), axis=0)
