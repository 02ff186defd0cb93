"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The reference has no distribution (SURVEY §2.2); these tests validate the
new capability: edge/node-partitioned execution must be bit-compatible with
single-device execution, and the full training step must compile + run
under real shardings.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import dgl_jax
from dgl_jax.models import GraphSAGE
from dgl_jax.ops import gspmm
from dgl_jax.parallel import device_mesh, graph_sharding, replicated, shard_graph

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _toy(rng, n=256, e=1024, d=16):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    g = dgl_jax.from_edges(src, dst, n, e_pad=1024)
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    return g, x


def test_sharded_spmm_matches_single_device(rng):
    g, x = _toy(rng)
    ref = np.asarray(gspmm(g, "copy_u", "mean", x=x))

    mesh = device_mesh((1, 8), ("data", "graph"))
    g_sh = shard_graph(g, mesh)
    x_sh = jax.device_put(x, NamedSharding(mesh, P("graph")))
    out = jax.jit(lambda g, x: gspmm(g, "copy_u", "mean", x=x))(g_sh, x_sh)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-6)


def test_sharded_training_step_runs_and_matches(rng):
    g, x = _toy(rng)
    y = jnp.asarray(rng.integers(0, 4, g.num_nodes))
    model = GraphSAGE(hidden_feats=16, out_feats=4, num_layers=2)
    params = model.init(jax.random.PRNGKey(0), g, x)["params"]

    def loss_fn(p, g, x, y):
        logits = model.apply({"params": p}, g, x)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    grads_ref = jax.grad(loss_fn)(params, g, x, y)

    mesh = device_mesh((1, 8), ("data", "graph"))
    g_sh = shard_graph(g, mesh)
    x_sh = jax.device_put(x, NamedSharding(mesh, P("graph")))
    y_sh = jax.device_put(y, NamedSharding(mesh, P("graph")))
    p_sh = jax.device_put(params, replicated(mesh))
    grads = jax.jit(jax.grad(loss_fn))(p_sh, g_sh, x_sh, y_sh)

    for a, b in zip(jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(grads_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_graft_entry_dryrun():
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[0] == 1024
    ge.dryrun_multichip(8)


def test_halo_spmm_matches_single_device(rng):
    from dgl_jax.parallel import halo_spmm, shard_fullgraph, place
    from dgl_jax.ops import gspmm

    n, e, d = 300, 2000, 8
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    g = dgl_jax.from_edges(src, dst, n)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ref = np.asarray(gspmm(g, "copy_u", "mean", x=jnp.asarray(x)))

    mesh = device_mesh((1, 8), ("data", "graph"))
    sg, n_pad = shard_fullgraph(src, dst, n, 8)
    sg = place(sg, mesh)
    x_pad = np.zeros((n_pad, d), np.float32)
    x_pad[:n] = x
    x_sh = jax.device_put(jnp.asarray(x_pad), NamedSharding(mesh, P("graph")))
    out = jax.jit(lambda sg, x: halo_spmm(sg, x, mesh))(sg, x_sh)
    np.testing.assert_allclose(np.asarray(out)[:n], ref, rtol=1e-4, atol=1e-5)
    # backward flows through all_gather -> reduce_scatter transpose
    grad = jax.jit(jax.grad(lambda x: jnp.sum(halo_spmm(sg, x, mesh) ** 2)))(x_sh)
    assert np.all(np.isfinite(np.asarray(grad)))


def test_dp_minibatch_training(rng):
    """8-way data-parallel sampled minibatch step: grads == mean of
    single-replica grads."""
    import optax
    from dgl_jax.models import GraphSAGE
    from dgl_jax.parallel import make_dp_train_step, stack_minibatches
    from dgl_jax.sampling import CSRGraph, MultiLayerNeighborSampler

    n, e, d, c = 200, 1500, 8, 4
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    csr = CSRGraph.from_edges(src, dst, n)
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    y = jnp.asarray(rng.integers(0, c, n))

    sampler = MultiLayerNeighborSampler([3, 3])
    mbs = [sampler.sample(csr, rng.choice(n, 16, replace=False), rng, 16) for _ in range(8)]
    stacked = stack_minibatches(mbs)

    model = GraphSAGE(hidden_feats=8, out_feats=c, num_layers=2, dropout=0.0)
    params = model.init(jax.random.PRNGKey(0), mbs[0].blocks,
                        jnp.take(x, mbs[0].input_nodes, axis=0))["params"]
    tx = optax.sgd(0.1)
    opt = tx.init(params)

    def loss_fn(p, mb, x, y):
        bx = jnp.take(x, mb.input_nodes, axis=0)
        by = jnp.take(y, mb.seeds, axis=0)
        logits = model.apply({"params": p}, mb.blocks, bx)
        logp = jax.nn.log_softmax(logits)
        ce = -jnp.take_along_axis(logp, by[:, None], 1)[:, 0]
        m = mb.seed_mask.astype(ce.dtype)
        return jnp.sum(ce * m) / jnp.maximum(m.sum(), 1.0)

    mesh = device_mesh((8, 1), ("data", "graph"))
    step = make_dp_train_step(loss_fn, tx, mesh)
    new_params, opt, loss = step(params, opt, stacked, x, y)

    # oracle: mean of per-replica losses/grads
    losses, grads = [], []
    for mb in mbs:
        l, g = jax.value_and_grad(loss_fn)(params, mb, x, y)
        losses.append(float(l))
        grads.append(g)
    np.testing.assert_allclose(float(loss), np.mean(losses), rtol=1e-5)
    mean_grads = jax.tree_util.tree_map(lambda *gs: sum(gs) / len(gs), *grads)
    ref_params = optax.apply_updates(params, tx.update(mean_grads, tx.init(params), params)[0])
    for a, b in zip(jax.tree_util.tree_leaves(new_params), jax.tree_util.tree_leaves(ref_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_boundary_halo_matches_allgather_halo(rng):
    """Boundary-only all_to_all exchange must equal the all-gather halo and
    the single-device SpMM; exchange volume must actually shrink."""
    from dgl_jax.parallel import (
        halo_spmm, halo_spmm_boundary, place, shard_fullgraph,
        shard_fullgraph_boundary,
    )
    from dgl_jax.ops import gspmm

    n, e, d = 400, 3000, 8
    # locality-ish graph so boundaries are smaller than everything
    src = np.clip(rng.integers(0, n, e) + rng.integers(-40, 40, e), 0, n - 1)
    dst = rng.integers(0, n, e)
    g = dgl_jax.from_edges(src, dst, n)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ref = np.asarray(gspmm(g, "copy_u", "mean", x=jnp.asarray(x)))

    mesh = device_mesh((1, 8), ("data", "graph"))
    bs, n_pad = shard_fullgraph_boundary(src, dst, n, 8)
    assert bs.rows_per_pair < bs.nodes_per_shard * 8  # smaller than full gather
    sh = NamedSharding(mesh, P("graph"))
    bs_sh = jax.device_put(bs, jax.tree_util.tree_map(lambda _: sh, bs))
    x_pad = np.zeros((n_pad, d), np.float32)
    x_pad[:n] = x
    x_sh = jax.device_put(jnp.asarray(x_pad), sh)
    out = jax.jit(lambda b, x: halo_spmm_boundary(b, x, mesh))(bs_sh, x_sh)
    np.testing.assert_allclose(np.asarray(out)[:n], ref, rtol=1e-4, atol=1e-5)
    # gradient flows (all_to_all transpose)
    grad = jax.jit(jax.grad(lambda x: jnp.sum(halo_spmm_boundary(bs_sh, x, mesh) ** 2)))(x_sh)
    assert np.all(np.isfinite(np.asarray(grad)))


def test_halo_sage_matches_dense_oracle(rng):
    """The sharded-SAGE forward (boundary halo, local/halo split) must match
    the plain fc_self + fc_neigh(mean-agg) math on one device, and a full
    train step must move the loss."""
    import optax
    from dgl_jax.parallel import (
        halo_sage_apply, halo_sage_init, make_halo_train_step,
        shard_fullgraph_boundary,
    )

    n, e, d, c = 300, 2200, 12, 5
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    x = rng.standard_normal((n, d)).astype(np.float32)

    mesh = device_mesh((1, 8), ("data", "graph"))
    bs, n_pad = shard_fullgraph_boundary(src, dst, n, 8)
    row = NamedSharding(mesh, P("graph"))
    bs = jax.device_put(bs, jax.tree_util.tree_map(lambda _: row, bs))
    x_pad = np.zeros((n_pad, d), np.float32)
    x_pad[:n] = x
    x_sh = jax.device_put(jnp.asarray(x_pad), row)

    params = halo_sage_init(jax.random.PRNGKey(0), d, 8, c, 2)
    out = jax.jit(lambda p, b, xx: halo_sage_apply(p, b, xx, mesh))(params, bs, x_sh)

    # dense numpy oracle (mean agg, zero-in-degree rows -> 0 neighbor term)
    g = dgl_jax.from_edges(src, dst, n)
    h = x
    for i, layer in enumerate(params):
        agg = np.asarray(gspmm(g, "copy_u", "mean", x=jnp.asarray(h)))
        h = h @ np.asarray(layer["w_self"]) + agg @ np.asarray(layer["w_neigh"]) + np.asarray(layer["bias"])
        if i < len(params) - 1:
            h = np.maximum(h, 0)
    np.testing.assert_allclose(np.asarray(out)[:n], h, rtol=2e-4, atol=2e-5)

    # one training step decreases the loss on a learnable target
    y = jax.device_put(
        jnp.zeros((n_pad,), jnp.int32).at[:n].set(jnp.asarray(rng.integers(0, c, n))), row
    )
    mask = jax.device_put(jnp.ones((n_pad,), jnp.bool_).at[n:].set(False), row)
    tx = optax.adam(1e-2)
    step = make_halo_train_step(mesh, tx, dropout=0.0)
    opt = tx.init(params)
    key = jax.random.PRNGKey(1)
    _, _, l0 = step(params, opt, key, bs, x_sh, y, mask)
    p, o = params, opt
    for _ in range(20):
        p, o, l1 = step(p, o, key, bs, x_sh, y, mask)
    assert float(l1) < float(l0)


def test_halo_gat_matches_dense_oracle(rng):
    """Sharded GAT attention (boundary exchange + bound-shift softmax over
    local+halo edges) must match the single-device edge-softmax math, and
    gradients must flow through the all_to_all transpose."""
    from dgl_jax.parallel import (
        halo_gat_apply, halo_gat_boundary, halo_gat_init,
        shard_fullgraph_boundary,
    )

    n, e, nh, dh = 320, 2500, 3, 5
    src = np.clip(rng.integers(0, n, e) + rng.integers(-40, 40, e), 0, n - 1)
    dst = rng.integers(0, n, e)

    z = rng.standard_normal((n, nh, dh)).astype(np.float32)
    a_s = rng.standard_normal((n, nh)).astype(np.float32)
    a_d = rng.standard_normal((n, nh)).astype(np.float32)

    # dense oracle: per-dst softmax of leaky_relu(a_s[u] + a_d[v]) over
    # in-edges, weighted sum of z[u]
    logits = a_s[src] + a_d[dst]
    logits = np.where(logits > 0, logits, 0.2 * logits)
    ref = np.zeros((n, nh, dh), np.float32)
    for v in range(n):
        m = dst == v
        if not m.any():
            continue
        lv = logits[m]
        p = np.exp(lv - lv.max(axis=0, keepdims=True))
        p = p / p.sum(axis=0, keepdims=True)
        ref[v] = (p[:, :, None] * z[src[m]]).sum(axis=0)

    mesh = device_mesh((1, 8), ("data", "graph"))
    bs, n_pad = shard_fullgraph_boundary(src, dst, n, 8)
    sh = NamedSharding(mesh, P("graph"))
    bs_sh = jax.device_put(bs, jax.tree_util.tree_map(lambda _: sh, bs))

    def pad(a):
        out = np.zeros((n_pad,) + a.shape[1:], np.float32)
        out[:n] = a
        return jax.device_put(jnp.asarray(out), sh)

    z_sh, as_sh, ad_sh = pad(z), pad(a_s), pad(a_d)
    out = jax.jit(
        lambda b, z, s, d: halo_gat_boundary(b, z, s, d, mesh)
    )(bs_sh, z_sh, as_sh, ad_sh)
    np.testing.assert_allclose(np.asarray(out)[:n], ref, rtol=1e-4, atol=1e-5)

    grad = jax.jit(jax.grad(
        lambda z: jnp.sum(halo_gat_boundary(bs_sh, z, as_sh, ad_sh, mesh) ** 2)
    ))(z_sh)
    assert np.all(np.isfinite(np.asarray(grad)))

    # full sharded GAT stack runs and produces finite sharded logits
    params = halo_gat_init(jax.random.PRNGKey(0), 10, 6, 4, heads=(2, 2))
    x_sh = pad(rng.standard_normal((n, 10)).astype(np.float32))
    logits_sh = jax.jit(
        lambda p, b, x: halo_gat_apply(p, b, x, mesh, heads=(2, 2))
    )(params, bs_sh, x_sh)
    assert logits_sh.shape == (n_pad, 4)
    assert np.all(np.isfinite(np.asarray(logits_sh)))


def test_halo_rgcn_matches_gspmm_rel(rng):
    """Sharded relation-contracted SpMM (halo_rgcn_boundary) must equal the
    single-device gspmm_rel on the same graph + weights, and the full
    sharded RGCN forward must run with finite grads."""
    from dgl_jax.ops.spmm import gspmm_rel
    from dgl_jax.parallel import (
        halo_rgcn_apply, halo_rgcn_boundary, halo_rgcn_init,
        plan_layout_edata_boundary, shard_fullgraph_boundary,
    )

    n, e, R, D = 320, 2600, 4, 6
    src = np.clip(rng.integers(0, n, e) + rng.integers(-30, 30, e), 0, n - 1)
    dst = rng.integers(0, n, e)
    w = rng.random((e, R)).astype(np.float32)
    y = rng.standard_normal((n, R, D)).astype(np.float32)

    g = dgl_jax.from_edges(src, dst, n)
    ref = np.asarray(gspmm_rel("mean", 2, g, jnp.asarray(y),
                               g.permute_edata(jnp.asarray(w))))

    mesh = device_mesh((1, 8), ("data", "graph"))
    out = shard_fullgraph_boundary(src, dst, n, 8, return_eids=True)
    bs, n_pad, leids, heids = out
    w_loc, w_hal = plan_layout_edata_boundary(bs, leids, heids, w)
    sh = NamedSharding(mesh, P("graph"))
    bs_sh = jax.device_put(bs, jax.tree_util.tree_map(lambda _: sh, bs))
    y_pad = np.zeros((n_pad, R * D), np.float32)
    y_pad[:n] = y.reshape(n, R * D)
    y_sh = jax.device_put(jnp.asarray(y_pad), sh)
    w_loc = jax.device_put(w_loc, sh)
    w_hal = jax.device_put(w_hal, sh)

    got = jax.jit(lambda bs, y, wl, wh: halo_rgcn_boundary(
        bs, y, wl, wh, R, mesh))(bs_sh, y_sh, w_loc, w_hal)
    np.testing.assert_allclose(np.asarray(got)[:n], ref, rtol=1e-4, atol=1e-5)

    # full sharded RGCN forward + grads
    x_pad = np.zeros((n_pad, 5), np.float32)
    x_pad[:n] = rng.standard_normal((n, 5)).astype(np.float32)
    x_sh = jax.device_put(jnp.asarray(x_pad), sh)
    params = halo_rgcn_init(jax.random.PRNGKey(0), 5, 8, 3, R, num_layers=2)

    def loss(p):
        return jnp.sum(halo_rgcn_apply(p, bs_sh, x_sh, w_loc, w_hal, R, mesh) ** 2)

    v, grads = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(v))
    for leaf in jax.tree_util.tree_leaves(grads):
        assert np.all(np.isfinite(np.asarray(leaf)))
