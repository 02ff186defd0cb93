"""Graph partitioning for cluster-batched training.

Equivalent of the reference's METIS dependency
(``dgl.transform.metis_partition`` in ``cluster-sage/dgl/partition_utils.py:
9-16``, ``metis_partition_assignment`` in ``dgl_cluster_sampler.py:24``),
with the same on-disk caching behavior (partition assignment cached to
``.npy`` keyed by dataset+psize, ``cluster-sage/dgl/sampler.py:33-41``).

METIS itself is not available in this environment; the default partitioner
is multi-source label propagation (BFS region growing from random seeds)
with a size-balancing pass — the locality property Cluster-GCN needs
(edges mostly inside parts). ``method="random"`` gives the degenerate
baseline. A native C++ partitioner can be slotted in via the same
interface.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["partition_assignment", "get_partition_list"]

# bump when partitioner semantics/quality change — keyed into the cache
# filename so stale assignments from older code are never reused
# (v2: grow-phase leftover attach weight-capped + refine sheds over-cap
# parts; balance 8.3 -> 1.08 at arxiv k=165, cut 73% -> 64%)
_PART_CACHE_VERSION = 2


def _label_propagation_partition(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    k: int,
    rng: np.random.Generator,
    rounds: int = 30,
) -> np.ndarray:
    """Multi-source BFS growth: seed k random nodes, iteratively let
    unassigned nodes adopt a neighbor's partition; then balance."""
    part = np.full(num_nodes, -1, dtype=np.int64)
    seeds = rng.choice(num_nodes, size=min(k, num_nodes), replace=False)
    part[seeds] = np.arange(len(seeds))

    for _ in range(rounds):
        unassigned_dst = part[dst] < 0
        ok = unassigned_dst & (part[src] >= 0)
        if not ok.any():
            break
        # last-writer-wins vectorized adoption (effectively random neighbor)
        part[dst[ok]] = part[src[ok]]
        unassigned_src = part[src] < 0
        ok = unassigned_src & (part[dst] >= 0)
        part[src[ok]] = part[dst[ok]]
        if (part >= 0).all():
            break
    # orphans (disconnected): assign round-robin
    orphans = np.where(part < 0)[0]
    part[orphans] = rng.integers(0, k, size=len(orphans))

    return _balance(part, k)


def _balance(part: np.ndarray, k: int, cap_ratio: float = 1.3) -> np.ndarray:
    """Move overflow above ``cap_ratio × ideal`` into parts below the ideal
    size. Vectorized (one sort + fancy assignment); the per-part loop runs
    only over oversized parts. LP without this collapses at high k (products
    k=15000: max part 1227× ideal; with it, ≤ cap)."""
    n = len(part)
    target = int(np.ceil(n / k))
    cap = max(int(target * cap_ratio), target + 1)
    counts = np.bincount(part, minlength=k)
    over = np.where(counts > cap)[0]
    if not len(over):
        return part
    order = np.argsort(part, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(counts)])
    excess = np.concatenate(
        [order[offsets[p] + cap : offsets[p + 1]] for p in over]
    )
    under = np.where(counts < target)[0]
    slots = np.repeat(under, target - counts[under])
    part = part.copy()
    m = min(len(excess), len(slots))
    part[excess[:m]] = slots[:m]
    if m < len(excess):  # leftover (cap rounding): spread round-robin
        part[excess[m:]] = np.arange(len(excess) - m) % k
    return part


def partition_assignment(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    k: int,
    *,
    method: str = "lp",
    seed: int = 0,
    cache_dir: Optional[str] = None,
    cache_key: Optional[str] = None,
) -> np.ndarray:
    """(num_nodes,) partition id per node; cached like the reference."""
    if cache_dir and cache_key:
        # keyed by seed + edge count + a strided content hash so a different
        # --seed or a structurally changed graph under the same name (e.g. a
        # regenerated synthetic dataset with identical counts) never
        # silently reuses a stale partition
        h = 0
        if len(src):
            step = max(len(src) // 4096, 1)
            h = int(
                (np.asarray(src[::step], np.int64) * 31
                 + np.asarray(dst[::step], np.int64)).sum()
            ) & 0xFFFFFFFF
        path = os.path.join(
            cache_dir,
            f"{cache_key}_part_v{_PART_CACHE_VERSION}_{k}_{method}_s{seed}"
            f"_e{len(src)}_h{h:08x}.npy",
        )
        if os.path.exists(path):
            return np.load(path)
    rng = np.random.default_rng(seed)
    if method == "random":
        part = rng.integers(0, k, size=num_nodes)
    elif method == "metis":
        # native multilevel (matching-coarsen + grow + refine); measured far
        # better locality than plain LP (reddit-like: ~10% edge cut vs ~75%)
        from ..csrc import native

        part = native.partition_multilevel(src, dst, num_nodes, k, seed)
        if part is None:
            part = _label_propagation_partition(src, dst, num_nodes, k, rng)
    elif method == "lp":
        from ..csrc import native

        part = native.partition_lp(src, dst, num_nodes, k, 30, seed)
        if part is None:
            part = _label_propagation_partition(src, dst, num_nodes, k, rng)
        else:
            part = _balance(np.asarray(part), k)
    else:
        raise ValueError(f"unknown partition method {method!r}")
    if cache_dir and cache_key:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(path, part)
    return part


def partition_stats(
    src: np.ndarray, dst: np.ndarray, part: np.ndarray, k: int
) -> dict:
    """Quality metrics of a partition: ``edge_cut`` (fraction of edges
    crossing parts — METIS minimizes this) and ``balance`` (max part size /
    ideal size; 1.0 = perfect). Cluster-method accuracy and halo exchange
    volume both depend on these, so drivers log them."""
    cut = float(np.mean(part[src] != part[dst])) if len(src) else 0.0
    counts = np.bincount(part, minlength=k)
    balance = float(counts.max() / max(len(part) / k, 1))
    return {"edge_cut": cut, "balance": balance, "parts": int(k)}


def get_partition_list(part: np.ndarray, k: int):
    """Partition id array → list of node-id arrays (reference
    ``get_partition_list`` shape, ``partition_utils.py``)."""
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=k)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return [order[offsets[i] : offsets[i + 1]] for i in range(k)]
