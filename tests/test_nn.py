"""Layer/model tests: shapes, math parity vs hand-computed oracles, grads.

Mirrors the reference's cross-framework equivalence oracle (SURVEY §4.3) by
checking each layer against an independent dense NumPy computation with the
layer's own extracted parameters.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dgl_jax import from_edges, batch_graphs
from dgl_jax.nn import (
    SAGEConv,
    GATConv,
    GCNConv,
    RelGraphConv,
    MaskedBatchNorm,
    DotPredictor,
)
from dgl_jax.models import GraphSAGE, GAT, GCNGraphClassifier, RGCN


def _graph(rng, n=10, e=30):
    src = rng.integers(0, n, size=e)
    dst = rng.integers(0, n, size=e)
    return from_edges(src, dst, n), src, dst


def test_sage_conv_math(rng):
    n, e, din, dout = 10, 30, 6, 4
    g, src, dst = _graph(rng, n, e)
    x = rng.standard_normal((n, din)).astype(np.float32)
    conv = SAGEConv(dout, aggr="mean")
    params = conv.init(jax.random.PRNGKey(0), g, jnp.asarray(x))
    out = conv.apply(params, g, jnp.asarray(x))

    # oracle: mean-aggregate then two linears
    agg = np.zeros((n, din), dtype=np.float64)
    cnt = np.zeros(n)
    for u, v in zip(src, dst):
        agg[v] += x[u]
        cnt[v] += 1
    agg = agg / np.maximum(cnt, 1)[:, None]
    w_self = np.asarray(params["params"]["fc_self"]["kernel"])
    w_neigh = np.asarray(params["params"]["fc_neigh"]["kernel"])
    b_neigh = np.asarray(params["params"]["fc_neigh_bias"])
    ref = x @ w_self + agg @ w_neigh + b_neigh
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-5)


def test_sage_conv_project_first_equals_aggregate_first(rng):
    """The bandwidth reordering (project→aggregate when out<in) must be
    numerically equivalent to aggregate→project (same params)."""
    n, e = 12, 40
    g, src, dst = _graph(rng, n, e)
    x_wide = jnp.asarray(rng.standard_normal((n, 10)).astype(np.float32))
    conv_narrow = SAGEConv(4, aggr="mean")   # out < in → project first
    params = conv_narrow.init(jax.random.PRNGKey(0), g, x_wide)
    out = np.asarray(conv_narrow.apply(params, g, x_wide))
    # oracle: aggregate first with the same extracted params
    agg = np.zeros((n, 10))
    cnt = np.zeros(n)
    xw = np.asarray(x_wide)
    for u, v in zip(src, dst):
        agg[v] += xw[u]
        cnt[v] += 1
    agg /= np.maximum(cnt, 1)[:, None]
    ref = (
        xw @ np.asarray(params["params"]["fc_self"]["kernel"])
        + agg @ np.asarray(params["params"]["fc_neigh"]["kernel"])
        + np.asarray(params["params"]["fc_neigh_bias"])
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_gat_conv_math(rng):
    n, e, din, dout, H = 8, 25, 5, 3, 2
    g, src, dst = _graph(rng, n, e)
    x = rng.standard_normal((n, din)).astype(np.float32)
    conv = GATConv(dout, num_heads=H)
    params = conv.init(jax.random.PRNGKey(1), g, jnp.asarray(x))
    out = np.asarray(conv.apply(params, g, jnp.asarray(x)))

    W = np.asarray(params["params"]["fc"]["kernel"])  # (din, H*dout)
    al = np.asarray(params["params"]["attn_l"])  # (1,H,dout)
    ar = np.asarray(params["params"]["attn_r"])
    z = (x @ W).reshape(n, H, dout)
    el = (z * al).sum(-1)  # dst half
    er = (z * ar).sum(-1)  # src half
    ref = np.zeros((n, H, dout))
    for v in range(n):
        idx = np.where(dst == v)[0]
        if len(idx) == 0:
            continue
        logits = el[v][None, :] + er[src[idx]]  # (k, H)
        logits = np.where(logits >= 0, logits, 0.2 * logits)  # leaky_relu
        logits = logits - logits.max(axis=0, keepdims=True)
        a = np.exp(logits) / np.exp(logits).sum(axis=0, keepdims=True)
        ref[v] = (a[:, :, None] * z[src[idx]]).sum(axis=0)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


def test_gcn_conv_math(rng):
    n, e, din, dout = 9, 28, 4, 3
    g, src, dst = _graph(rng, n, e)
    x = rng.standard_normal((n, din)).astype(np.float32)
    conv = GCNConv(dout)
    params = conv.init(jax.random.PRNGKey(2), g, jnp.asarray(x))
    out = np.asarray(conv.apply(params, g, jnp.asarray(x)))

    W = np.asarray(params["params"]["fc"]["kernel"])
    h = x @ W
    deg = np.bincount(dst, minlength=n) + 1.0
    dis = deg ** -0.5
    ref = np.zeros((n, dout))
    for u, v in zip(src, dst):
        ref[v] += h[u] * dis[u]
    ref *= dis[:, None]
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_rel_graph_conv_fused_matches_loop(rng):
    n, e, d, R = 8, 24, 4, 3
    g, src, dst = _graph(rng, n, e)
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    ew = jnp.asarray(rng.random((g.num_edges_padded, R)).astype(np.float32))
    loop = RelGraphConv(5, num_relations=R, fuse_relations=False)
    fused = RelGraphConv(5, num_relations=R, fuse_relations=True)
    params = loop.init(jax.random.PRNGKey(3), g, x, ew)
    out_l = loop.apply(params, g, x, ew)
    out_f = fused.apply(params, g, x, ew)
    np.testing.assert_allclose(np.asarray(out_l), np.asarray(out_f), rtol=1e-4, atol=1e-5)


def test_masked_batchnorm_ignores_padding(rng):
    x_valid = rng.standard_normal((10, 4)).astype(np.float32)
    x_pad = np.concatenate([x_valid, 100.0 * np.ones((6, 4), np.float32)])
    mask = np.concatenate([np.ones(10), np.zeros(6)]).astype(np.float32)
    bn = MaskedBatchNorm()
    params = bn.init(jax.random.PRNGKey(0), jnp.asarray(x_pad), jnp.asarray(mask))
    out, _ = bn.apply(
        params, jnp.asarray(x_pad), jnp.asarray(mask), mutable=["batch_stats"]
    )
    mean = x_valid.mean(axis=0)
    var = x_valid.var(axis=0)
    ref = (x_valid - mean) / np.sqrt(var + 1e-5)
    np.testing.assert_allclose(np.asarray(out)[:10], ref, rtol=1e-3, atol=1e-4)


def test_graphsage_model_end_to_end(rng):
    n, e, d, c = 20, 60, 8, 3
    g, _, _ = _graph(rng, n, e)
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    model = GraphSAGE(hidden_feats=16, out_feats=c, num_layers=2)
    params = model.init(jax.random.PRNGKey(0), g, x)
    logits = model.apply(params, g, x)
    assert logits.shape == (n, c)

    labels = jnp.asarray(rng.integers(0, c, size=n))

    def loss_fn(p):
        lg = model.apply(p, g, x)
        return -jnp.mean(
            jnp.take_along_axis(jax.nn.log_softmax(lg), labels[:, None], axis=1)
        )

    grads = jax.grad(loss_fn)(params)
    flat = jax.tree_util.tree_leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(l))) for l in flat)
    assert any(np.abs(np.asarray(l)).max() > 0 for l in flat)


def test_gat_model_shapes(rng):
    n, e, d, c = 15, 40, 6, 4
    g, _, _ = _graph(rng, n, e)
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    model = GAT(hidden_feats=8, out_feats=c, heads=(4, 4, 2))
    params = model.init(jax.random.PRNGKey(0), g, x)
    out = model.apply(params, g, x)
    assert out.shape == (n, c)


def test_gcn_graph_classifier(rng):
    graphs = []
    for _ in range(5):
        n = int(rng.integers(4, 9))
        e = int(rng.integers(5, 15))
        graphs.append((rng.integers(0, n, e), rng.integers(0, n, e), n))
    batch = batch_graphs(graphs, num_graphs=8)
    x = jnp.asarray(rng.standard_normal((batch.num_nodes_padded, 6)).astype(np.float32))
    model = GCNGraphClassifier(hidden_feats=12, num_classes=4, num_layers=3)
    variables = model.init(jax.random.PRNGKey(0), batch, x)
    out = model.apply(variables, batch, x)
    assert out.shape == (8, 4)
    # valid graphs get finite log-probs summing to ~1 in prob space
    probs = np.exp(np.asarray(out[:5]))
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-4)


def test_rgcn_model(rng):
    n, e, R = 12, 40, 4
    g, _, _ = _graph(rng, n, e)
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    ew = jnp.asarray(rng.random((g.num_edges_padded, R)).astype(np.float32))
    model = RGCN(hidden_feats=16, out_feats=5, num_relations=R, num_layers=2)
    params = model.init(jax.random.PRNGKey(0), g, x, ew)
    out = model.apply(params, g, x, ew)
    assert out.shape == (n, 5)


def test_dot_predictor(rng):
    n, e = 8, 20
    g, src, dst = _graph(rng, n, e)
    h = rng.standard_normal((n, 4)).astype(np.float32)
    pred = DotPredictor()
    params = pred.init(jax.random.PRNGKey(0), g, jnp.asarray(h))
    scores = np.asarray(pred.apply(params, g, jnp.asarray(h)))
    eid = np.asarray(g.eid)[: g.num_edges]
    ref = np.sum(h[src] * h[dst], axis=1)[eid]
    np.testing.assert_allclose(scores[: g.num_edges], ref, rtol=1e-4, atol=1e-5)


def test_sage_conv_bipartite_block(rng):
    # sampled-block style: 12 src nodes, first 5 are dst nodes
    n_src, n_dst, e = 12, 5, 20
    src = rng.integers(0, n_src, size=e)
    dst = rng.integers(0, n_dst, size=e)
    g = from_edges(src, dst, n_src, n_dst)
    x = jnp.asarray(rng.standard_normal((n_src, 6)).astype(np.float32))
    conv = SAGEConv(4)
    params = conv.init(jax.random.PRNGKey(0), g, (x, x[:n_dst]))
    out = conv.apply(params, g, (x, x[:n_dst]))
    assert out.shape == (n_dst, 4)


def test_gat_training_grads(rng):
    """Regression: GATConv must be differentiable end-to-end (the custom
    gather VJP once carried a non-pytree residual that broke jax.grad)."""
    n, e, d, c = 20, 80, 6, 3
    g, _, _ = _graph(rng, n, e)
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    y = jnp.asarray(rng.integers(0, c, n))
    model = GAT(hidden_feats=4, out_feats=c, heads=(2, 1))
    params = model.init(jax.random.PRNGKey(0), g, x)["params"]

    def loss(p):
        lg = model.apply({"params": p}, g, x)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(lg), y[:, None], 1))

    grads = jax.grad(loss)(params)
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
    assert any(np.abs(np.asarray(l)).max() > 0 for l in leaves)


def test_sage_bf16_messages_close(rng):
    """bf16 neighbor messages approximate the f32 path to bf16 tolerance."""
    n, e = 30, 200
    g, _, _ = _graph(rng, n, e)
    x = jnp.asarray(rng.standard_normal((n, 24)).astype(np.float32))
    c32 = SAGEConv(8, aggr="mean")
    cbf = SAGEConv(8, aggr="mean", msg_dtype=jnp.bfloat16)
    params = c32.init(jax.random.PRNGKey(0), g, x)
    o32 = np.asarray(c32.apply(params, g, x))
    obf = np.asarray(cbf.apply(params, g, x))
    assert obf.dtype == np.float32
    np.testing.assert_allclose(obf, o32, rtol=2e-2, atol=2e-2)


def test_gcn_conv_edge_math(rng):
    """GCNConvEdge vs manual oracle (molhiv semantics: norm·relu(x+w_e),
    plus relu(x+root)/deg self term)."""
    from dgl_jax.nn import GCNConvEdge

    n, e, d = 9, 25, 5
    g, src, dst = _graph(rng, n, e)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w_in = rng.standard_normal((e, d)).astype(np.float32)
    w_canon = g.permute_edata(jnp.asarray(w_in))
    conv = GCNConvEdge(d)
    params = conv.init(jax.random.PRNGKey(0), g, jnp.asarray(x), w_canon)
    out = np.asarray(conv.apply(params, g, jnp.asarray(x), w_canon))

    W = np.asarray(params["params"]["fc"]["kernel"])
    root = np.asarray(params["params"]["root_emb"])[0]
    h = x @ W
    deg = np.bincount(dst, minlength=n) + 1.0
    c = deg ** -0.5
    ref = np.zeros((n, d))
    for i, (u, v) in enumerate(zip(src, dst)):
        ref[v] += c[u] * c[v] * np.maximum(h[u] + w_in[i], 0.0)
    ref += np.maximum(h + root, 0.0) / deg[:, None]
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


def test_rel_graph_conv_math(rng):
    """RelGraphConv vs manual oracle (proteins semantics: per-relation
    u_mul_e mean then per-relation projection, summed, plus dense skip)."""
    n, e, d, R, dout = 8, 22, 4, 3, 5
    g, src, dst = _graph(rng, n, e)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ew_in = rng.random((e, R)).astype(np.float32)
    ew_canon = g.permute_edata(jnp.asarray(ew_in))
    conv = RelGraphConv(dout, num_relations=R)
    params = conv.init(jax.random.PRNGKey(0), g, jnp.asarray(x), ew_canon)
    out = np.asarray(conv.apply(params, g, jnp.asarray(x), ew_canon))

    Wr = np.asarray(params["params"]["rel_weights"])  # (R, d, dout)
    Ws = np.asarray(params["params"]["skip"]["kernel"])
    bs = np.asarray(params["params"]["skip"]["bias"])
    acc = np.zeros((n, dout))
    deg = np.bincount(dst, minlength=n)
    for r in range(R):
        agg = np.zeros((n, d))
        for i, (u, v) in enumerate(zip(src, dst)):
            agg[v] += x[u] * ew_in[i, r]
        agg /= np.maximum(deg, 1)[:, None]
        acc += agg @ Wr[r]
    ref = acc + x @ Ws + bs
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


def test_gatconv_memory_safe_path_matches(rng, monkeypatch):
    """The huge-graph attention variant (node-side logit dots + fused
    binary aggregation, auto-edge-chunked) must match the shared-gather
    path in value and grads."""
    import dgl_jax
    from dgl_jax.nn import GATConv

    n, e = 60, 400
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    g = dgl_jax.from_edges(src, dst, n)
    x = jnp.asarray(rng.standard_normal((n, 12)).astype(np.float32))
    conv = GATConv(out_feats=8, num_heads=2)
    params = conv.init(jax.random.PRNGKey(0), g, x)

    ref = conv.apply(params, g, x)
    ref_grad = jax.grad(lambda x: jnp.sum(conv.apply(params, g, x) ** 2))(x)

    monkeypatch.setenv("DGL_JAX_MSG_BUDGET_GB", "1e-7")  # force the variant
    out = conv.apply(params, g, x)
    grad = jax.grad(lambda x: jnp.sum(conv.apply(params, g, x) ** 2))(x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(ref_grad),
                               rtol=1e-3, atol=1e-4)


def test_gat_block_positional_matches_generic(rng):
    """GATConv's positional fanout-block path (reshape softmax + einsum)
    must match the generic edge-softmax path on the same block."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import dgl_jax
    from dgl_jax.nn import GATConv

    nd, f, d_in = 6, 3, 10
    n_src = nd + nd * f
    src = nd + np.arange(nd * f)
    dst = np.repeat(np.arange(nd), f)
    g_pos = dataclasses.replace(
        dgl_jax.from_edges(src, dst, n_src, num_dst_nodes=nd),
        block_fanout=f)
    g_gen = dgl_jax.from_edges(src, dst, n_src, num_dst_nodes=nd)

    x = jnp.asarray(rng.standard_normal((n_src, d_in)).astype(np.float32))
    feat = (x, x[:nd])  # block convention (models/gat.py: (h, h[:num_dst]))
    conv = GATConv(out_feats=5, num_heads=4)
    params = conv.init(jax.random.PRNGKey(0), g_gen, feat)
    out_gen = conv.apply(params, g_gen, feat)
    out_pos = conv.apply(params, g_pos, feat)
    assert out_pos.shape == (nd, 4, 5)
    np.testing.assert_allclose(np.asarray(out_pos), np.asarray(out_gen),
                               rtol=2e-5, atol=2e-5)

    def loss(p, g):
        return jnp.sum(conv.apply(p, g, feat) ** 2)

    g1 = jax.grad(loss)(params, g_gen)
    g2 = jax.grad(loss)(params, g_pos)
    for k in ("attn_l", "attn_r"):
        np.testing.assert_allclose(
            np.asarray(g2["params"][k]), np.asarray(g1["params"][k]),
            rtol=1e-4, atol=1e-4)
