"""Unit tests: SpMM / SDDMM / edge-softmax vs dense NumPy oracles.

Covers the kernel surface of SURVEY §2.3 rows 1–3 on tiny random graphs,
including bipartite shapes, zero-in-degree nodes, padding invariance and
gradients (finite-difference-free: compared against oracle-built closed
forms via jax.grad on the dense formulation).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dgl_jax import from_edges
from dgl_jax.ops import gspmm, gsddmm, edge_softmax

from utils import dense_spmm, dense_sddmm, dense_edge_softmax

jax.config.update("jax_enable_x64", False)


def _mk(rng, n_src=13, n_dst=11, n_e=40, e_pad=None):
    src = rng.integers(0, n_src, size=n_e).astype(np.int64)
    dst = rng.integers(0, n_dst, size=n_e).astype(np.int64)
    g = from_edges(src, dst, n_src, n_dst, e_pad=e_pad)
    return g, src, dst


@pytest.mark.parametrize("op", ["copy_u", "add", "sub", "mul", "div", "copy_e"])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_spmm_matches_dense(rng, op, reduce):
    n_src, n_dst, n_e, d = 13, 11, 40, 5
    g, src, dst = _mk(rng, n_src, n_dst, n_e)
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    e_in = rng.standard_normal((n_e, d)).astype(np.float32) + 2.0  # avoid /0

    # edge data must be permuted into canonical order
    e_canon = g.permute_edata(jnp.asarray(e_in))
    out = gspmm(
        g,
        op,
        reduce,
        x=None if op == "copy_e" else jnp.asarray(x),
        e=None if op == "copy_u" else e_canon,
    )
    ref = dense_spmm(
        src,
        dst,
        n_src,
        n_dst,
        None if op == "copy_e" else x,
        None if op == "copy_u" else e_in,
        op,
        reduce,
    )
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-4)


def test_spmm_zero_in_degree_is_zero(rng):
    # node 5 has no in-edges; mean/sum/max must produce 0 (DGL semantics)
    src = np.array([0, 1, 2])
    dst = np.array([0, 0, 1])
    g = from_edges(src, dst, 6, 6)
    x = rng.standard_normal((6, 3)).astype(np.float32)
    for reduce in ["sum", "mean", "max", "min"]:
        out = np.asarray(gspmm(g, "copy_u", reduce, x=jnp.asarray(x)))
        np.testing.assert_allclose(out[2:], 0.0)


def test_spmm_padding_invariance(rng):
    """Same graph, different padded lengths → identical results."""
    n_src, n_dst, n_e, d = 9, 9, 23, 4
    src = rng.integers(0, n_src, size=n_e)
    dst = rng.integers(0, n_dst, size=n_e)
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    outs = []
    for e_pad in [128, 256, 384]:
        g = from_edges(src, dst, n_src, n_dst, e_pad=e_pad)
        outs.append(np.asarray(gspmm(g, "copy_u", "mean", x=jnp.asarray(x))))
    np.testing.assert_allclose(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], outs[2])


@pytest.mark.parametrize("op,reduce", [("copy_u", "sum"), ("copy_u", "mean"), ("mul", "sum"), ("add", "mean")])
def test_spmm_grads(rng, op, reduce):
    """Custom VJP vs jax.grad of an explicit dense formulation."""
    n, n_e, d = 8, 20, 3
    src = rng.integers(0, n, size=n_e)
    dst = rng.integers(0, n, size=n_e)
    g = from_edges(src, dst, n, n)
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    e_in = jnp.asarray(rng.standard_normal((n_e, d)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))  # loss weights

    A = np.zeros((n, n), dtype=np.float32)  # A[v,u] = multiplicity
    for u, v in zip(src, dst):
        A[v, u] += 1.0

    e_canon = g.permute_edata(e_in)

    def loss_ours(x, e):
        ec = g.permute_edata(e)
        out = gspmm(g, op, reduce, x=x, e=None if op == "copy_u" else ec)
        return jnp.sum(out * w)

    def loss_dense(x, e):
        # dense scatter formulation (autodiffed by JAX as the oracle)
        msgs = x[jnp.asarray(src)] if op != "copy_e" else None
        if op == "mul":
            msgs = msgs * e
        elif op == "add":
            msgs = msgs + e
        out = jax.ops.segment_sum(msgs, jnp.asarray(dst), num_segments=n)
        if reduce == "mean":
            deg = jnp.maximum(A.sum(axis=1), 1.0)
            out = out / deg[:, None]
        return jnp.sum(out * w)

    gx, ge = jax.grad(loss_ours, argnums=(0, 1))(x, e_in)
    gx_ref, ge_ref = jax.grad(loss_dense, argnums=(0, 1))(x, e_in)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(gx_ref), rtol=1e-4, atol=1e-5)
    if op != "copy_u":
        np.testing.assert_allclose(np.asarray(ge), np.asarray(ge_ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "dot", "copy_u", "copy_v"])
def test_sddmm_matches_dense(rng, op):
    n_src, n_dst, n_e, d = 7, 9, 30, 4
    g, src, dst = _mk(rng, n_src, n_dst, n_e)
    u = rng.standard_normal((n_src, d)).astype(np.float32)
    v = rng.standard_normal((n_dst, d)).astype(np.float32)
    out = np.asarray(gsddmm(g, op, jnp.asarray(u), jnp.asarray(v)))
    ref = dense_sddmm(src, dst, u, v, op)
    # our output is in canonical order: map via eid
    eid = np.asarray(g.eid)[: g.num_edges]
    np.testing.assert_allclose(out[: g.num_edges], ref[eid], rtol=1e-5, atol=1e-5)
    # padding rows are zeroed
    np.testing.assert_allclose(out[g.num_edges :], 0.0)


def test_edge_softmax_matches_dense(rng):
    n, n_e, h = 10, 35, 4
    src = rng.integers(0, n, size=n_e)
    dst = rng.integers(0, n, size=n_e)
    g = from_edges(src, dst, n, n)
    logits = rng.standard_normal((n_e, h)).astype(np.float32) * 5
    lc = g.permute_edata(jnp.asarray(logits))
    alpha = np.asarray(edge_softmax(g, lc))
    ref = dense_edge_softmax(src, dst, n, logits)
    eid = np.asarray(g.eid)[: g.num_edges]
    np.testing.assert_allclose(alpha[: g.num_edges], ref[eid], rtol=1e-5, atol=1e-6)
    # alpha sums to 1 per destination with in-edges
    sums = np.zeros((n, h))
    d_canon = np.asarray(g.dst)[: g.num_edges]
    for i, v in enumerate(d_canon):
        sums[v] += alpha[i]
    has_edge = np.unique(d_canon)
    np.testing.assert_allclose(sums[has_edge], 1.0, rtol=1e-5)
    # padded entries contribute exactly zero
    np.testing.assert_allclose(alpha[g.num_edges :], 0.0)


def test_edge_softmax_loose_bound_rescued(rng):
    """A dst_bound pathologically far above the true max (> f32's ~88 exp
    range) used to underflow every exp for the row and return all-zero
    attention via the tiny-clamp; the guard must detect the
    zeroed denominator and rescue with the exact segment-max path."""
    n, n_e = 12, 40
    src = rng.integers(0, n, size=n_e)
    dst = rng.integers(0, n, size=n_e)
    g = from_edges(src, dst, n, n)
    logits = rng.standard_normal((n_e,)).astype(np.float32)
    lc = g.permute_edata(jnp.asarray(logits))
    ref = np.asarray(edge_softmax(g, lc))
    # a valid but absurdly loose upper bound: +200 above everything
    bound = jnp.full((n,), float(logits.max()) + 200.0, jnp.float32)
    alpha = np.asarray(edge_softmax(g, lc, dst_bound=bound))
    np.testing.assert_allclose(alpha, ref, rtol=1e-5, atol=1e-6)
    # and a sane bound still takes the cheap path and matches
    bound_ok = jnp.full((n,), float(logits.max()) + 1.0, jnp.float32)
    alpha_ok = np.asarray(edge_softmax(g, lc, dst_bound=bound_ok))
    np.testing.assert_allclose(alpha_ok, ref, rtol=1e-5, atol=1e-6)


def test_edge_softmax_loose_bound_grad_finite(rng):
    """Backward through the loose-bound path: a bound ~40-80 above the true
    max shrinks denom to ~exp(-looseness); the quotient backward carries
    1/denom^2, which overflowed f32 (inf * 0 = NaN) before the round-5
    eps-rescue widening. Measured in the wild: cora GAT (feat_drop 0.6
    widens the logit spread to ~55) NaN'd its params in the FIRST backward
    and published random-accuracy rows. Grads must stay finite for bounds
    on BOTH sides of the rescue threshold."""
    n, n_e = 12, 40
    src = rng.integers(0, n, size=n_e)
    dst = rng.integers(0, n, size=n_e)
    g = from_edges(src, dst, n, n)
    logits = jnp.asarray(rng.standard_normal((n_e, 2)).astype(np.float32))

    for loose in (15.0, 40.0, 60.0, 200.0):
        bound = jnp.full((n,), float(logits.max()) + loose, jnp.float32)

        def f(l):
            a = edge_softmax(g, g.permute_edata(l), dst_bound=bound)
            return jnp.sum(a ** 2)

        grad = jax.grad(f)(logits)
        assert np.all(np.isfinite(np.asarray(grad))), f"loose={loose}"
        # and the values themselves still match the exact softmax
        ref = np.asarray(edge_softmax(g, g.permute_edata(logits)))
        got = np.asarray(edge_softmax(g, g.permute_edata(logits), dst_bound=bound))
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6)


def test_edge_softmax_grad_finite(rng):
    n, n_e = 6, 15
    src = rng.integers(0, n, size=n_e)
    dst = rng.integers(0, n, size=n_e)
    g = from_edges(src, dst, n, n)
    logits = jnp.asarray(rng.standard_normal((n_e, 2)).astype(np.float32))

    def f(l):
        return jnp.sum(edge_softmax(g, g.permute_edata(l)) ** 2)

    grad = jax.grad(f)(logits)
    assert np.all(np.isfinite(np.asarray(grad)))


def test_degrees(rng):
    n_src, n_dst, n_e = 12, 10, 50
    g, src, dst = _mk(rng, n_src, n_dst, n_e)
    np.testing.assert_array_equal(
        np.asarray(g.in_degrees()), np.bincount(dst, minlength=n_dst)
    )
    np.testing.assert_array_equal(
        np.asarray(g.out_degrees()), np.bincount(src, minlength=n_src)
    )


def test_spmm_jit_and_vmap_compatible(rng):
    g, src, dst = _mk(rng, 8, 8, 20)
    x = jnp.asarray(rng.standard_normal((8, 4)).astype(np.float32))
    f = jax.jit(lambda g, x: gspmm(g, "copy_u", "mean", x=x))
    out1 = f(g, x)
    out2 = gspmm(g, "copy_u", "mean", x=x)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2), rtol=1e-6)


def test_gather_dst_scan_path(rng, monkeypatch):
    """Force the scan-based dst gather and compare against plain take,
    including zero-degree nodes and an exactly-full edge array."""
    monkeypatch.setenv("DGL_JAX_SEGSUM", "cumsum")
    from dgl_jax.ops.gather import gather_dst

    n = 20
    # include zero-degree nodes (no in-edges for nodes 15..19)
    src = rng.integers(0, n, 128)
    dst = rng.integers(0, 15, 128)
    g = from_edges(src, dst, n, e_pad=128)  # exactly full, no padding
    assert g.num_edges_padded == g.num_edges == 128
    v = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    out = np.asarray(gather_dst(g, v))
    ref = np.asarray(v)[np.asarray(g.dst)]
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)

    # padded case: only valid rows must match
    g2 = from_edges(src[:100], dst[:100], n, e_pad=256)
    out2 = np.asarray(gather_dst(g2, v))[: g2.num_edges]
    ref2 = np.asarray(v)[np.asarray(g2.dst)[: g2.num_edges]]
    np.testing.assert_allclose(out2, ref2, rtol=1e-4, atol=1e-5)


def test_edge_softmax_scan_path_matches(rng, monkeypatch):
    n, n_e = 30, 300
    src = rng.integers(0, n, n_e)
    dst = rng.integers(0, n, n_e)
    g = from_edges(src, dst, n)
    logits = jnp.asarray(rng.standard_normal((g.num_edges_padded, 2)).astype(np.float32))
    monkeypatch.setenv("DGL_JAX_SEGSUM", "scatter")
    a_ref = np.asarray(edge_softmax(g, logits))
    monkeypatch.setenv("DGL_JAX_SEGSUM", "cumsum")
    a_scan = np.asarray(edge_softmax(g, logits))
    np.testing.assert_allclose(a_scan[: g.num_edges], a_ref[: g.num_edges],
                               rtol=1e-4, atol=1e-5)


def test_spmm_feature_chunking_matches(rng, monkeypatch):
    """Column-chunked copy_u SpMM (memory bounding) must match unchunked,
    values and grads."""
    n, n_e, d = 40, 300, 12
    src = rng.integers(0, n, n_e)
    dst = rng.integers(0, n, n_e)
    g = from_edges(src, dst, n)
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    ref = np.asarray(gspmm(g, "copy_u", "mean", x=x))
    ref_g = np.asarray(jax.grad(lambda x: jnp.sum(gspmm(g, "copy_u", "mean", x=x) ** 2))(x))
    # force chunking: budget smaller than E_pad * d * 4
    monkeypatch.setenv("DGL_JAX_MSG_BUDGET_GB", str(g.num_edges_padded * 4 * 4 / (1 << 30)))
    out = np.asarray(gspmm(g, "copy_u", "mean", x=x))
    gr = np.asarray(jax.grad(lambda x: jnp.sum(gspmm(g, "copy_u", "mean", x=x) ** 2))(x))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gr, ref_g, rtol=1e-5, atol=1e-6)


def test_segment_sum_blocked_accuracy(rng, monkeypatch):
    """Blocked segment sum must match the exact scatter tightly even on
    all-positive data where the plain scan drifts (prefix-magnitude ulp)."""
    from dgl_jax.ops.segment import segment_sum_blocked, segment_sum

    n, n_e, d = 500, 60000, 4
    src = rng.integers(0, n, n_e)
    dst = rng.integers(0, n, n_e)
    g = from_edges(src, dst, n)
    assert g.segblocks is not None
    msg = jnp.asarray(
        np.abs(rng.standard_normal((g.num_edges_padded, d))).astype(np.float32)
    ) * g.edge_mask()[:, None]
    out = np.asarray(segment_sum_blocked(msg, g.segblocks, n))
    ref = np.asarray(segment_sum(msg, g.dst, n, sorted=True))
    np.testing.assert_allclose(out, ref, rtol=3e-6, atol=1e-5)
    # and through the gspmm scan gate
    monkeypatch.setenv("DGL_JAX_SEGSUM", "cumsum")
    x = jnp.asarray(np.abs(rng.standard_normal((n, d))).astype(np.float32))
    a = np.asarray(gspmm(g, "copy_u", "sum", x=x))
    monkeypatch.setenv("DGL_JAX_SEGSUM", "scatter")
    b = np.asarray(gspmm(g, "copy_u", "sum", x=x))
    np.testing.assert_allclose(a, b, rtol=3e-6, atol=1e-5)


def test_edge_input_order_invariance(rng):
    """Canonicalization makes results independent of edge input order."""
    n, n_e, d = 15, 60, 4
    src = rng.integers(0, n, n_e)
    dst = rng.integers(0, n, n_e)
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    perm = rng.permutation(n_e)
    g1 = from_edges(src, dst, n)
    g2 = from_edges(src[perm], dst[perm], n)
    o1 = np.asarray(gspmm(g1, "copy_u", "mean", x=x))
    o2 = np.asarray(gspmm(g2, "copy_u", "mean", x=x))
    np.testing.assert_allclose(o1, o2, rtol=1e-6)


def test_node_relabel_equivariance(rng):
    """Permuting node ids permutes outputs correspondingly."""
    n, n_e, d = 12, 50, 3
    src = rng.integers(0, n, n_e)
    dst = rng.integers(0, n, n_e)
    x = rng.standard_normal((n, d)).astype(np.float32)
    perm = rng.permutation(n)  # new id of old node i is perm[i]
    g1 = from_edges(src, dst, n)
    g2 = from_edges(perm[src], perm[dst], n)
    x2 = np.zeros_like(x)
    x2[perm] = x
    o1 = np.asarray(gspmm(g1, "copy_u", "sum", x=jnp.asarray(x)))
    o2 = np.asarray(gspmm(g2, "copy_u", "sum", x=jnp.asarray(x2)))
    np.testing.assert_allclose(o2[perm], o1, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_spmm_edge_chunked_matches(rng, reduce, k):
    """_spmm_xe_echunk (bounded-memory binary SpMM) must match the fused
    path bit-for-bit in value and in grads wrt x and e, for any chunk
    count — including chunks that straddle the sentinel-padded tail."""
    from dgl_jax.ops.spmm import _spmm_xe, _spmm_xe_echunk

    n_src, n_dst, n_e, d = 29, 23, 150, 6
    g, src, dst = _mk(rng, n_src, n_dst, n_e)
    x = jnp.asarray(rng.standard_normal((n_src, d)).astype(np.float32))
    e = jnp.asarray(rng.standard_normal((g.num_edges_padded, 1)).astype(np.float32))

    ref = _spmm_xe("mul", reduce, True, g, x, e)
    out = _spmm_xe_echunk("mul", reduce, k, g, x, e)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-6, atol=1e-6)

    def loss_ref(x, e):
        return jnp.sum(_spmm_xe("mul", reduce, True, g, x, e) ** 2)

    def loss_chk(x, e):
        return jnp.sum(_spmm_xe_echunk("mul", reduce, k, g, x, e) ** 2)

    gr = jax.grad(loss_ref, argnums=(0, 1))(x, e)
    gc = jax.grad(loss_chk, argnums=(0, 1))(x, e)
    for a, b, name in zip(gc, gr, ("x", "e")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_spmm_edge_chunk_dispatch(rng, monkeypatch):
    """gspmm auto-dispatches huge binary messages to the edge-chunked path
    (shrunken budget so a tiny graph qualifies) with identical results."""
    import dgl_jax.ops.spmm as spmm_mod

    n, d = 40, 8
    g, src, dst = _mk(rng, n, n, 300)
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    e = jnp.asarray(rng.standard_normal((g.num_edges_padded, 1)).astype(np.float32))
    ref = np.asarray(gspmm(g, "mul", "mean", x=x, e=e))
    monkeypatch.setenv("DGL_JAX_MSG_BUDGET_GB", "0.0000004")  # ~430 bytes / 4
    out = np.asarray(gspmm(g, "mul", "mean", x=x, e=e))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("k", [1, 4])
def test_gspmm_rel_matches_loop(rng, reduce, k):
    """gspmm_rel (relation-contracted SpMM) must equal the per-relation
    gspmm loop in value and grads — the RGCN fast-path identity
    Σ_r agg(x·w_r)@W_r == one pass over y_r = x@W_r stacked."""
    from dgl_jax.ops.spmm import gspmm_rel

    n_src, n_dst, n_e, R, d = 31, 27, 180, 5, 4
    g, src, dst = _mk(rng, n_src, n_dst, n_e)
    y = jnp.asarray(rng.standard_normal((n_src, R, d)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((g.num_edges_padded, R)).astype(np.float32))

    def loop_ref(y, w):
        return sum(
            gspmm(g, "mul", reduce, x=y[:, r], e=w[:, r : r + 1])
            for r in range(R)
        )

    ref = loop_ref(y, w)
    out = gspmm_rel(reduce, k, g, y, w)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-5)

    gr = jax.grad(lambda y, w: jnp.sum(loop_ref(y, w) ** 2), argnums=(0, 1))(y, w)
    gc = jax.grad(lambda y, w: jnp.sum(gspmm_rel(reduce, k, g, y, w) ** 2),
                  argnums=(0, 1))(y, w)
    for a, b, name in zip(gc, gr, ("y", "w")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_scatter_lowering_matches_fused(rng, monkeypatch):
    """DGL_JAX_LOWERING=scatter (the PyG-twin lowering drivers expose as
    --lowering scatter) must agree with the fused custom-VJP path in both
    values and gradients — it is the same math, different cost profile."""
    import os

    import jax
    import jax.numpy as jnp

    import dgl_jax
    from dgl_jax.ops import gspmm

    n, e = 120, 900
    g = dgl_jax.from_edges(rng.integers(0, n, e), rng.integers(0, n, e), n)
    x = jnp.asarray(rng.standard_normal((n, 9)).astype(np.float32))
    ed = jnp.asarray(rng.standard_normal((g.num_edges_padded, 9)).astype(np.float32))

    def run(op, reduce, use_e):
        def f(x, ed):
            out = gspmm(g, op, reduce, x=None if op == "copy_e" else x,
                        e=ed if use_e else None)
            return jnp.sum(out ** 2)
        return f

    for op, reduce, use_e in [("copy_u", "sum", False), ("copy_u", "mean", False),
                              ("mul", "sum", True), ("copy_e", "mean", True)]:
        f = run(op, reduce, use_e)
        monkeypatch.delenv("DGL_JAX_LOWERING", raising=False)
        v0 = f(x, ed)
        gx0, ge0 = jax.grad(f, argnums=(0, 1))(x, ed)
        monkeypatch.setenv("DGL_JAX_LOWERING", "scatter")
        v1 = f(x, ed)
        gx1, ge1 = jax.grad(f, argnums=(0, 1))(x, ed)
        monkeypatch.delenv("DGL_JAX_LOWERING")
        np.testing.assert_allclose(v0, v1, rtol=2e-5, err_msg=f"{op}.{reduce}")
        np.testing.assert_allclose(gx0, gx1, rtol=2e-4, atol=1e-4,
                                   err_msg=f"grad x {op}.{reduce}")
        np.testing.assert_allclose(ge0, ge1, rtol=2e-4, atol=1e-4,
                                   err_msg=f"grad e {op}.{reduce}")


def test_copyu_edge_chunked_matches_exact(rng, monkeypatch):
    """Edge-chunked wide copy_u (the big-graph path: one row pass total,
    live set E/k x D) must match the unchunked op in values and grads —
    including through gspmm's budget-based dispatch."""
    import jax
    import jax.numpy as jnp

    import dgl_jax
    from dgl_jax.ops import gspmm
    from dgl_jax.ops.spmm import _spmm_copyu_echunk

    n, e = 150, 1100
    g = dgl_jax.from_edges(rng.integers(0, n, e), rng.integers(0, n, e), n)
    x = jnp.asarray(rng.standard_normal((n, 12)).astype(np.float32))

    for reduce in ("sum", "mean"):
        ref = gspmm(g, "copy_u", reduce, x=x, exact=True)
        out = _spmm_copyu_echunk(reduce, 5, g, x)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        gref = jax.grad(lambda x: jnp.sum(gspmm(g, "copy_u", reduce, x=x) ** 2))(x)
        gout = jax.grad(lambda x: jnp.sum(_spmm_copyu_echunk(reduce, 5, g, x) ** 2))(x)
        np.testing.assert_allclose(gout, gref, rtol=1e-4, atol=1e-4)

    # dispatch: a tiny budget must route through the edge-chunked path and
    # still match
    monkeypatch.setenv("DGL_JAX_MSG_BUDGET_GB", "0.00001")
    out2 = gspmm(g, "copy_u", "mean", x=x)
    monkeypatch.delenv("DGL_JAX_MSG_BUDGET_GB")
    np.testing.assert_allclose(out2, gspmm(g, "copy_u", "mean", x=x, exact=True),
                               rtol=1e-5, atol=1e-5)
