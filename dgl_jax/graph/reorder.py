"""Locality-preserving node reordering.

The gathers of message passing read source rows in edge order; how many
distinct cache lines and memory pages one block of edges touches is a
property of the *node ordering*. This module computes orderings that keep
edges inside contiguous node blocks:

* **hub extraction**: power-law graphs concentrate half their edges on a
  few thousand high-degree nodes. Packing those into the leading rows keeps
  their features together.
* **community blocks**: the rest of the nodes are ordered by a multilevel
  partition (``graph.partition`` — the METIS role), so homophilous edges
  land inside one block.

This is the analogue of DGL keeping CSR+CSC in cache-friendly layouts; the
reference gets locality implicitly from dataset node order + cuSPARSE.
Whether it pays on the GPU is open (ROADMAP D1 follow-up); drivers apply it
with ``--reorder``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .partition import partition_assignment

__all__ = ["locality_order", "apply_order"]


def locality_order(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    hub_count: Optional[int] = None,
    part_size: int = 1024,
    method: str = "metis",
    seed: int = 0,
    part: Optional[np.ndarray] = None,
    cache_dir: Optional[str] = None,
    cache_key: Optional[str] = None,
) -> np.ndarray:
    """Compute a locality order: returns ``order`` (old node ids in their
    new sequence; ``order[i]`` = old id of new node ``i``).

    Args:
      hub_count: nodes (by total degree) pulled to the front; default
        ``min(num_nodes // 16, 8192)`` (0 disables).
      part_size: target partition size for the community blocks.
      method: partitioner for the non-hub blocks (``metis``/``lp``/
        ``random`` — see :func:`graph.partition.partition_assignment`).
      part: precomputed partition assignment (skips the partitioner).
      cache_dir/cache_key: cache the multilevel partition to disk (the
        partitioner is minutes of host time at ogbn-products scale).
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if hub_count is None:
        hub_count = min(num_nodes // 16, 8192)
    if part is None:
        k = max(num_nodes // part_size, 2)
        part = partition_assignment(
            src, dst, num_nodes, k, method=method, seed=seed,
            cache_dir=cache_dir,
            cache_key=f"{cache_key}_locality" if cache_key else None,
        )
    deg = np.bincount(src, minlength=num_nodes) + np.bincount(dst, minlength=num_nodes)
    if hub_count > 0:
        hubs = np.argpartition(-deg, min(hub_count, num_nodes - 1))[:hub_count]
        hubs = hubs[np.argsort(-deg[hubs], kind="stable")]
        is_hub = np.zeros(num_nodes, bool)
        is_hub[hubs] = True
        rest = np.where(~is_hub)[0]
        rest = rest[np.argsort(part[rest], kind="stable")]
        return np.concatenate([hubs, rest])
    return np.argsort(part, kind="stable")


def apply_order(order: np.ndarray, src: np.ndarray, dst: np.ndarray, *arrays):
    """Relabel an edge list (and any node-indexed arrays) by ``order``.

    Returns ``(new_src, new_dst, *reordered_arrays, new_id)`` where
    ``new_id[old] = new`` (for relabelling anything else, e.g. seed node
    id lists)."""
    n = len(order)
    new_id = np.empty(n, dtype=np.int64)
    new_id[order] = np.arange(n)
    out = [new_id[np.asarray(src)], new_id[np.asarray(dst)]]
    for a in arrays:
        out.append(np.asarray(a)[order])
    out.append(new_id)
    return tuple(out)
