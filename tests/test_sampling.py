"""Tests: neighbor sampler, cluster iterator, partitioner, loaders."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dgl_jax.graph.partition import get_partition_list, partition_assignment
from dgl_jax.ops import gspmm
from dgl_jax.sampling import (
    ClusterIter,
    CSRGraph,
    GraphBatchLoader,
    MultiLayerNeighborSampler,
    NodeDataLoader,
)


def _rand_graph(rng, n=50, e=300):
    return rng.integers(0, n, e), rng.integers(0, n, e), n


def test_csr_graph(rng):
    src, dst, n = _rand_graph(rng)
    csr = CSRGraph.from_edges(src, dst, n)
    # every (src,dst) pair appears in the in-neighbor list of dst
    for v in range(n):
        nbrs = sorted(csr.indices[csr.indptr[v] : csr.indptr[v + 1]].tolist())
        ref = sorted(src[dst == v].tolist())
        assert nbrs == ref


def test_sampler_block_shapes_and_validity(rng):
    src, dst, n = _rand_graph(rng)
    csr = CSRGraph.from_edges(src, dst, n)
    sampler = MultiLayerNeighborSampler([3, 5])
    seeds = rng.choice(n, 8, replace=False)
    mb = sampler.sample(csr, seeds, rng, b_pad=8)
    assert len(mb.blocks) == 2
    outer, inner = mb.blocks
    # inner block: dst = seeds (8), src = 8 + 8*5
    assert inner.num_dst_nodes == 8 and inner.num_src_nodes == 8 + 40
    # outer block: dst = inner srcs
    assert outer.num_dst_nodes == 48 and outer.num_src_nodes == 48 + 48 * 3
    assert mb.input_nodes.shape[0] == outer.num_src_nodes
    # sampled neighbors are actual in-neighbors
    in_nbrs = {v: set(src[dst == v].tolist()) | {v} for v in range(n)}
    inputs = np.asarray(mb.input_nodes)
    inner_ids = inputs[: inner.num_src_nodes]  # block src original ids? inner srcs are first 48
    # dst nodes occupy the first num_dst src slots (tuple convention)
    np.testing.assert_array_equal(np.asarray(mb.seeds), inner_ids[:8])


@pytest.mark.parametrize("use_native", [True, False])
def test_sample_neighbors_noreplace(rng, use_native, monkeypatch):
    """Without-replacement semantics (reference ns-sage-dgl.py:132 default):
    deg>=fanout seeds get fanout DISTINCT in-neighbors; deg<fanout seeds get
    ALL their distinct neighbors (cyclically filled); zero-degree seeds get
    themselves. Native and NumPy fallback both satisfy the contract."""
    from dgl_jax.csrc import native

    if use_native and not native.available():
        pytest.skip("native lib unavailable")
    if not use_native:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    # graph with hubs (deg >> fanout), leaves (deg < fanout) and isolates
    n = 40
    src = np.concatenate([
        rng.integers(0, n, 400),          # bulk
        np.arange(5),                      # node 30 gets 5 distinct-ish
    ])
    dst = np.concatenate([
        np.zeros(400, np.int64),           # node 0 is a hub
        np.full(5, 30, np.int64),
    ])
    csr = CSRGraph.from_edges(src, dst, n)
    fanout = 7
    seeds = np.asarray([0, 30, 39])  # hub, low-degree, isolated
    out = native.sample_neighbors_noreplace(
        csr.indptr, csr.indices, seeds, fanout, 123)
    assert out.shape == (3, fanout)
    in_nbrs = {v: set(src[dst == v].tolist()) for v in range(n)}
    # hub: all distinct, all real in-neighbors
    hub = out[0].tolist()
    assert len(set(hub)) == fanout and set(hub) <= in_nbrs[0]
    # low-degree: support is exactly the full distinct neighbor set
    lo = set(out[1].tolist())
    assert lo == in_nbrs[30]
    # isolated: self
    assert set(out[2].tolist()) == {39}
    # determinism per seed
    out2 = native.sample_neighbors_noreplace(
        csr.indptr, csr.indices, seeds, fanout, 123)
    np.testing.assert_array_equal(out, out2)
    # distributional sanity on the hub: over many draws every in-neighbor
    # should appear (uniform distinct selection covers the support)
    seen = set()
    for s in range(50):
        o = native.sample_neighbors_noreplace(
            csr.indptr, csr.indices, np.asarray([0]), fanout, s)
        seen |= set(o[0].tolist())
    assert seen == in_nbrs[0]


def test_sampler_noreplace_end_to_end(rng):
    src, dst, n = _rand_graph(rng)
    csr = CSRGraph.from_edges(src, dst, n)
    sampler = MultiLayerNeighborSampler([3, 5], replace=False)
    seeds = rng.choice(n, 8, replace=False)
    mb = sampler.sample(csr, seeds, rng, b_pad=8)
    assert len(mb.blocks) == 2
    # every sampled input is a real in-neighbor (or a self-fill)
    in_nbrs = {v: set(src[dst == v].tolist()) | {v} for v in range(n)}
    inner = mb.blocks[1]
    inputs = np.asarray(mb.input_nodes)
    for i, s in enumerate(seeds):
        slots = inputs[8 + i * 5: 8 + (i + 1) * 5]
        assert set(slots.tolist()) <= in_nbrs[s]


def test_sampled_spmm_matches_manual_mean(rng):
    """mean over a block == mean over the sampled multiset of neighbors."""
    src, dst, n = _rand_graph(rng)
    csr = CSRGraph.from_edges(src, dst, n)
    sampler = MultiLayerNeighborSampler([4])
    seeds = rng.choice(n, 6, replace=False)
    mb = sampler.sample(csr, seeds, rng, b_pad=6)
    blk = mb.blocks[0]
    x = rng.standard_normal((blk.num_src_nodes, 3)).astype(np.float32)
    out = np.asarray(gspmm(blk, "copy_u", "mean", x=jnp.asarray(x)))
    for i in range(6):
        nbr_slots = 6 + 4 * i + np.arange(4)
        np.testing.assert_allclose(out[i], x[nbr_slots].mean(axis=0), rtol=1e-5)


def test_sampled_block_backward_sorted(rng):
    src, dst, n = _rand_graph(rng)
    csr = CSRGraph.from_edges(src, dst, n)
    mb = MultiLayerNeighborSampler([4]).sample(csr, rng.choice(n, 6, replace=False), rng, 6)
    blk = mb.blocks[0]
    assert blk.reverse is not None
    x = jnp.asarray(rng.standard_normal((blk.num_src_nodes, 3)).astype(np.float32))
    grad = jax.grad(lambda x: jnp.sum(gspmm(blk, "copy_u", "mean", x=x) ** 2))(x)
    assert np.all(np.isfinite(np.asarray(grad)))
    # reverse graph consistency: rev maps the same edges transposed
    rev = blk.reverse
    np.testing.assert_array_equal(np.asarray(rev.src)[: blk.num_edges],
                                  np.asarray(blk.dst)[: blk.num_edges])
    np.testing.assert_array_equal(np.asarray(rev.dst)[: blk.num_edges],
                                  np.asarray(blk.src)[: blk.num_edges])


def test_node_dataloader_covers_all_seeds(rng):
    src, dst, n = _rand_graph(rng)
    csr = CSRGraph.from_edges(src, dst, n)
    nids = np.arange(0, n, 2)
    loader = NodeDataLoader(csr, nids, MultiLayerNeighborSampler([2]), 8, shuffle=True)
    seen = []
    for mb in loader:
        seen.extend(np.asarray(mb.seeds)[np.asarray(mb.seed_mask)].tolist())
    assert sorted(seen) == sorted(nids.tolist())


def test_partition_assignment_covers_and_balances(rng):
    src, dst, n = _rand_graph(rng, n=200, e=1500)
    part = partition_assignment(src, dst, n, 10, seed=0)
    assert part.shape == (n,)
    assert part.min() >= 0 and part.max() < 10
    parts = get_partition_list(part, 10)
    assert sum(len(p) for p in parts) == n
    # locality: intra-partition edge fraction should beat random (1/k)
    intra = (part[src] == part[dst]).mean()
    assert intra > 1.5 / 10, f"partitioner no better than random: {intra}"


def test_partition_cache(tmp_path, rng):
    src, dst, n = _rand_graph(rng)
    p1 = partition_assignment(src, dst, n, 5, cache_dir=str(tmp_path), cache_key="t")
    p2 = partition_assignment(src, dst, n, 5, cache_dir=str(tmp_path), cache_key="t")
    np.testing.assert_array_equal(p1, p2)
    assert len(list(tmp_path.glob("*.npy"))) == 1


def test_cluster_iter(rng):
    src, dst, n = _rand_graph(rng, n=120, e=800)
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    train = rng.random(n) < 0.5
    it = ClusterIter("t", src, dst, n, feats, labels, train, psize=12, batch_size=4, seed=0)
    batches = list(it)
    assert len(batches) == 3
    total_nodes = sum(len(b.nodes) for b in batches)
    assert total_nodes == n  # partitions cover every node exactly once
    for b in batches:
        nv = len(b.nodes)
        # features are the original rows
        np.testing.assert_allclose(np.asarray(b.x)[:nv], feats[b.nodes], rtol=1e-6)
        # subgraph edges connect only in-batch nodes, relabelled in range
        # (validity is sentinel-based: cluster batches quantize num_edges
        # to the bucket so same-shape batches share one compiled program)
        valid = np.asarray(b.graph.dst) < b.graph.num_dst_nodes
        s = np.asarray(b.graph.src)[valid]
        d = np.asarray(b.graph.dst)[valid]
        assert s.max(initial=0) < nv and d.max(initial=0) < nv


def test_cluster_iter_negatives(rng):
    src, dst, n = _rand_graph(rng, n=60, e=400)
    feats = rng.standard_normal((n, 4)).astype(np.float32)
    it = ClusterIter(
        "tn", src, dst, n, feats, np.zeros(n, np.int64), np.ones(n, bool),
        psize=6, batch_size=2, with_negatives=True,
    )
    b = it.first()
    assert b.neg_graph is not None
    assert b.neg_graph.num_edges == b.graph.num_edges


def test_graph_batch_loader_bucketing(rng):
    graphs, feats, labels = [], [], []
    for _ in range(20):
        n = int(rng.integers(3, 10))
        e = int(rng.integers(3, 12))
        graphs.append((rng.integers(0, n, e), rng.integers(0, n, e), n))
        feats.append(rng.standard_normal((n, 4)).astype(np.float32))
        labels.append(int(rng.integers(0, 2)))
    loader = GraphBatchLoader(graphs, feats, np.asarray(labels), batch_size=8)
    shapes = set()
    count = 0
    for batch, nf, ef, y in loader:
        shapes.add((batch.num_nodes_padded, batch.graph.num_edges_padded))
        count += int(batch.graph_mask().sum())
    assert count == 20
    assert len(shapes) == 1  # single bucket → single compiled shape


def test_block_fanout_fast_path_matches_generic(rng):
    """The positional reshape-reduce fast path must equal the generic
    gather+segment path."""
    import dataclasses
    src, dst, n = _rand_graph(rng)
    csr = CSRGraph.from_edges(src, dst, n)
    mb = MultiLayerNeighborSampler([4]).sample(csr, rng.choice(n, 6, replace=False), rng, 6)
    blk = mb.blocks[0]
    assert blk.block_fanout == 4
    x = jnp.asarray(rng.standard_normal((blk.num_src_nodes, 5)).astype(np.float32))
    generic_blk = dataclasses.replace(blk, block_fanout=None)
    for red in ("sum", "mean", "max"):
        fast = np.asarray(gspmm(blk, "copy_u", red, x=x))
        ref = np.asarray(gspmm(generic_blk, "copy_u", red, x=x))
        np.testing.assert_allclose(fast, ref, rtol=1e-5, atol=1e-6)
    # gradients too
    g1 = jax.grad(lambda x: jnp.sum(gspmm(blk, "copy_u", "mean", x=x) ** 2))(x)
    g2 = jax.grad(lambda x: jnp.sum(gspmm(generic_blk, "copy_u", "mean", x=x) ** 2))(x)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-5, atol=1e-6)


def test_graph_batch_loader_epad_bound_holds_for_any_batch(rng):
    """Regression: e_pad must bound batches that maximize edges but not
    nodes (review finding — node-sorted chunks underestimated edges)."""
    graphs = [
        (rng.integers(0, 100, 10), rng.integers(0, 100, 10), 100),
        (rng.integers(0, 99, 1000), rng.integers(0, 99, 1000), 99),
        (rng.integers(0, 98, 10), rng.integers(0, 98, 10), 98),
        (rng.integers(0, 97, 1000), rng.integers(0, 97, 1000), 97),
    ]
    feats = [np.zeros((g[2], 3), np.float32) for g in graphs]
    loader = GraphBatchLoader(graphs, feats, np.zeros(4, np.int64), batch_size=2, seed=1)
    # iterate several shuffled epochs; the edge-heavy pair must collate fine
    for _ in range(6):
        for batch, nf, ef, y in loader:
            assert batch.graph.num_edges <= loader.e_pad


def test_device_sampler_matches_host_structure(rng):
    """DeviceNeighborSampler must produce the same static block structure
    as the host sampler (identical skeletons) and input_nodes that (a) keep
    seeds in the first B slots, (b) only reference true in-neighbors of
    their dst (or the dst itself for zero-in-degree nodes)."""
    import jax
    from dgl_jax.sampling import CSRGraph, DeviceNeighborSampler, MultiLayerNeighborSampler

    n, ne = 200, 900
    src = rng.integers(0, n, ne)
    dst = rng.integers(0, n, ne)
    csr = CSRGraph.from_edges(src, dst, n)
    fanouts = [3, 2]
    b = 16
    host = MultiLayerNeighborSampler(fanouts)
    dev = DeviceNeighborSampler(csr, fanouts)

    seeds = rng.choice(n, b, replace=False)
    mb_h = host.sample(csr, seeds, np.random.default_rng(0), b)
    mb_d = dev.sample(seeds, jax.random.PRNGKey(0), b)

    assert len(mb_h.blocks) == len(mb_d.blocks)
    for bh, bd in zip(mb_h.blocks, mb_d.blocks):
        assert bh.num_src_nodes == bd.num_src_nodes
        assert bh.num_dst_nodes == bd.num_dst_nodes
        np.testing.assert_array_equal(np.asarray(bh.src), np.asarray(bd.src))
        np.testing.assert_array_equal(np.asarray(bh.dst), np.asarray(bd.dst))
    inp = np.asarray(mb_d.input_nodes)
    assert inp.shape == np.asarray(mb_h.input_nodes).shape
    np.testing.assert_array_equal(inp[:b], seeds)

    # in-neighbor sets per node (graph semantics: edge src -> dst, sampler
    # draws in-neighbors of the dst/seed side)
    nbrs = {v: set(src[dst == v]) for v in range(n)}
    # walk the layered layout: slots [cur_len : cur_len + cur_len*fanout)
    # hold fanout samples per parent, innermost-first order mirrors host
    cur = inp[:b]
    off = b
    for fanout in reversed(fanouts):
        samp = inp[off : off + len(cur) * fanout].reshape(len(cur), fanout)
        for parent, row in zip(cur, samp):
            allowed = nbrs[parent] if nbrs[parent] else {parent}
            assert set(row.tolist()) <= allowed, (parent, row, allowed)
        cur = inp[: off + len(cur) * fanout]
        off = len(cur)

    # distribution sanity: a hub with many in-neighbors gets diverse draws
    hub_src = np.arange(100)
    hub_dst = np.zeros(100, np.int64)
    csr2 = CSRGraph.from_edges(hub_src, hub_dst, 101)
    dev2 = DeviceNeighborSampler(csr2, [50])
    mb = dev2.sample(np.zeros(4, np.int64), jax.random.PRNGKey(1), 4)
    draws = np.asarray(mb.input_nodes)[4:]
    assert len(np.unique(draws)) > 25  # ~50 draws x 4 seeds from 100 nbrs


def test_graph_batch_loader_device_cache(rng):
    """After the first epoch the loader replays device-resident batches in
    a fresh order (same composition) — later epochs must not re-collate."""
    graphs, feats, labels = [], [], []
    for _ in range(12):
        n = int(rng.integers(3, 8))
        e = int(rng.integers(3, 10))
        graphs.append((rng.integers(0, n, e), rng.integers(0, n, e), n))
        feats.append(rng.standard_normal((n, 4)).astype(np.float32))
        labels.append(int(rng.integers(0, 2)))
    from dgl_jax.sampling.dataloader import GraphBatchLoader

    ldr = GraphBatchLoader(graphs, feats, np.asarray(labels), 4, shuffle=True, seed=1)
    ep1 = list(ldr)
    assert ldr._cache is not None and len(ldr._cache) == len(ep1)
    ep2 = list(ldr)
    assert len(ep2) == len(ep1)
    # same OBJECTS, reordered — no re-collation
    ids1 = {id(b[1]) for b in ep1}
    assert all(id(b[1]) in ids1 for b in ep2)
    # labels multiset preserved
    l1 = np.sort(np.concatenate([np.asarray(b[3]) for b in ep1]))
    l2 = np.sort(np.concatenate([np.asarray(b[3]) for b in ep2]))
    np.testing.assert_array_equal(l1, l2)


def test_graph_batch_loader_stack_repads_pieces(rng):
    """stacked_cache() must stack every leaf even though the data-dependent
    segblocks piece arrays land in different half-octave buckets
    across batches (small final batch) — the sentinel repad makes them
    uniform WITHOUT changing any result (padding pieces are inert)."""
    import jax

    graphs, feats, labels = [], [], []
    for _ in range(11):  # 3 batches of 4, last batch has 3 graphs
        n = int(rng.integers(3, 30))
        e = int(rng.integers(3, 60))
        graphs.append((rng.integers(0, n, e), rng.integers(0, n, e), n))
        feats.append(rng.standard_normal((n, 4)).astype(np.float32))
        labels.append(int(rng.integers(0, 2)))
    from dgl_jax.sampling.dataloader import GraphBatchLoader

    ldr = GraphBatchLoader(graphs, feats, np.asarray(labels), 4, shuffle=True, seed=3)
    items = list(ldr)
    stacked, n_steps = ldr.stacked_cache()
    assert n_steps == len(items)
    shapes = {id(None)}
    for leaf in jax.tree_util.tree_leaves(stacked):
        assert leaf.shape[0] == n_steps
    del shapes
    # every stacked batch computes exactly what its loose item computed —
    # including batches whose piece arrays were sentinel-extended, and
    # through the gradient path (reverse-graph pieces repadded too)
    from dgl_jax.ops import gspmm

    for i in range(n_steps):
        b_i, nf_i, _, _ = items[i]
        bs, nfs, _, _ = jax.tree_util.tree_map(lambda a, i=i: a[i], stacked)

        def loss(g, x):
            return jnp.sum(gspmm(g, "copy_u", "sum", x=x) ** 2)

        va, ga = jax.value_and_grad(loss, argnums=1)(b_i.graph, nf_i)
        vb, gb = jax.value_and_grad(loss, argnums=1)(bs.graph, nfs)
        np.testing.assert_allclose(float(va), float(vb), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(ga), np.asarray(gb), rtol=1e-5)
