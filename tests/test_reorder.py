"""Multilevel partitioner quality + locality ordering tests.

The reference delegates partition quality to METIS
(``cluster-sage/dgl/partition_utils.py:9-16``); here the native multilevel
partitioner must (a) balance, (b) beat random cut substantially on a graph
with planted communities, and (c) produce orderings that keep edges inside
contiguous node blocks (locality for the gathers of message passing).
"""

import numpy as np
import pytest

from dgl_jax.graph.partition import partition_assignment, partition_stats
from dgl_jax.graph.reorder import apply_order, locality_order


def _planted(n, e, c, intra_frac, seed=3):
    """Planted-partition graph with `c` communities and vectorized edges."""
    rng = np.random.default_rng(seed)
    lab = np.repeat(np.arange(c), n // c)
    lab = np.concatenate([lab, rng.integers(0, c, n - len(lab))])
    lab = lab[rng.permutation(n)]
    order = np.argsort(lab, kind="stable")
    counts = np.bincount(lab, minlength=c)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    src = rng.integers(0, n, e)
    intra = rng.random(e) < intra_frac
    cls = lab[src]
    pick = offsets[cls] + (rng.random(e) * counts[cls]).astype(np.int64)
    dst = np.where(intra, order[np.minimum(pick, n - 1)], rng.integers(0, n, e))
    return src.astype(np.int64), dst.astype(np.int64), n, lab


@pytest.fixture
def community_graph():
    """16 communities of 250, 80% intra edges (small, for partition tests)."""
    return _planted(4000, 60000, 16, 0.8)


def test_multilevel_beats_random_cut(community_graph):
    src, dst, n, lab = community_graph
    k = 16
    part = partition_assignment(src, dst, n, k, method="metis", seed=0)
    stats = partition_stats(src, dst, part, k)
    rand = partition_stats(
        src, dst, partition_assignment(src, dst, n, k, method="random", seed=0), k
    )
    # random cut ≈ 1 - 1/k ≈ 0.94; with 80% intra edges and 16 true
    # communities a decent partitioner should land well under half of that
    assert stats["edge_cut"] < 0.55 * rand["edge_cut"], (stats, rand)
    assert stats["balance"] < 1.3, stats
    # deterministic given the seed
    part2 = partition_assignment(src, dst, n, k, method="metis", seed=0)
    assert np.array_equal(part, part2)


def test_locality_order_improves_block_locality():
    # sparser graph (deg ~5): 32 communities of ~1250 over 40k nodes
    src, dst, n, _ = _planted(40_000, 200_000, 32, 0.8, seed=5)
    order = locality_order(src, dst, n, part_size=1024, hub_count=1024, seed=0)
    assert np.array_equal(np.sort(order), np.arange(n))  # a permutation
    s2, d2, new_id = apply_order(order, src, dst)
    assert np.array_equal(new_id[order], np.arange(n))

    def intra_block(s, d, block=1024):
        """Share of edges whose endpoints fall in the same node block."""
        return float(np.mean(s // block == d // block))

    nat, opt = intra_block(src, dst), intra_block(s2, d2)
    assert opt > 4 * nat, (nat, opt)


def test_apply_order_relabels_node_arrays(community_graph):
    src, dst, n, lab = community_graph
    order = locality_order(src, dst, n, seed=1)
    s2, d2, lab2, new_id = apply_order(order, src, dst, lab)
    # edge endpoints keep their labels under the relabelling
    assert np.array_equal(lab2[s2], lab[src])
    assert np.array_equal(lab2[d2], lab[dst])
