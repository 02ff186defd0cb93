"""g-SpMM: fused (gather → binary op → segment reduce) message passing.

Equivalent of the generalized SpMM kernel the reference suite
benchmarks directly (``kernel/dgl-new.py:20`` — ``dgl.ops.gspmm``) and calls
from every model (``g.update_all(fn.copy_src, fn.mean)``
``main_dgl_citation_sage.py:75-77``; ``fn.u_mul_e``
``main_dgl_proteins_rgcn_for.py:52``).

Semantics: for every destination node ``v``::

    out[v] = reduce_{e=(u,v) in E} op(x[u], w[e])

* ``op``     ∈ {copy_u, copy_e, add, sub, mul, div}
* ``reduce`` ∈ {sum, mean, max, min}
* zero in-degree nodes produce 0 (DGL semantics).

Implementation notes:

* Edges are canonically dst-sorted, so the forward reduce is a *sorted*
  segment reduction.
* A custom VJP routes the backward scatter through the precomputed reverse
  graph, so the grad-wrt-x reduction is *also* sorted (this replaces DGL's
  CSR/CSC dual-format trick). Without it, AD of the gather would emit an
  unsorted scatter-add.
* Edge features must be given in canonical order with padded length E_pad
  (use ``Graph.permute_edata`` when they come in input order).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..graph.graph import Graph
from ..memory import msg_budget_bytes
from .gather import gather_dst
from .segment import (
    segment_max,
    segment_mean,
    segment_min,
    segment_sum,
    segment_sum_blocked,
    segment_sum_sorted_scan,
    use_scan_reductions,
)

__all__ = ["gspmm", "copy_u_sum", "copy_u_mean", "u_mul_e_sum"]

_BINARY_WITH_X = ("copy_u", "copy_lhs", "add", "sub", "mul", "div")
_BINARY_WITH_E = ("copy_e", "copy_rhs", "add", "sub", "mul", "div")


def _combine(op: str, xe, w):
    if op in ("copy_u", "copy_lhs"):
        return xe
    if op in ("copy_e", "copy_rhs"):
        return w
    if op == "add":
        return xe + w
    if op == "sub":
        return xe - w
    if op == "mul":
        return xe * w
    if op == "div":
        return xe / w
    raise ValueError(f"unknown spmm op: {op}")


def _gather_src(g: Graph, x):
    return jnp.take(x, jnp.minimum(g.src, g.num_src_nodes - 1), axis=0)


def _seg_sum_by_dst(g: Graph, msg, exact: bool = False):
    """Sum messages (canonical order) by destination; (E_pad,...) → (N_dst,...).
    A sorted scatter-add by default; ``DGL_JAX_SEGSUM=cumsum`` selects the
    blocked prefix-scan formulation, whose reassociation costs ~1e-5
    relative error. ``exact=True`` forces the sorted scatter regardless of
    the mode (one-time precomputes). bf16 messages take the sorted scatter
    with an f32 accumulator: a bf16 prefix scan would lose precision, and
    the f32 convert fuses into the scatter without materializing an f32
    (E, D) buffer."""
    if msg.dtype == jnp.bfloat16:
        return segment_sum(
            msg.astype(jnp.float32), g.dst, g.num_dst_nodes, sorted=True
        )
    if exact:
        return segment_sum(msg, g.dst, g.num_dst_nodes, sorted=True)
    if use_scan_reductions():
        if g.segblocks is not None:
            # blocked formulation: scan speed, scatter-grade accuracy
            return segment_sum_blocked(msg, g.segblocks, g.num_dst_nodes)
        return segment_sum_sorted_scan(msg, g.indptr)
    return segment_sum(msg, g.dst, g.num_dst_nodes, sorted=True)


def _reduce(g: Graph, msg, reduce: str, exact: bool = False):
    n = g.num_dst_nodes
    if reduce == "sum":
        return _seg_sum_by_dst(g, msg, exact)
    if reduce == "mean":
        s = _seg_sum_by_dst(g, msg, exact)
        inv = _inv_deg(g, s.dtype)
        return s * inv.reshape(inv.shape + (1,) * (s.ndim - 1))
    if reduce == "max":
        return segment_max(msg, g.dst, n, sorted=True)
    if reduce == "min":
        return segment_min(msg, g.dst, n, sorted=True)
    raise ValueError(f"unknown spmm reduce: {reduce}")


def _inv_deg(g: Graph, dtype):
    deg = jnp.maximum(g.in_degrees(), 1).astype(dtype)
    return 1.0 / deg


# -- custom-VJP core for ops that gather x (sum/mean reduce) ---------------
#
# fwd:  out = segment_sum_by_dst(op(x[src], e)) [* 1/deg for mean]
# bwd:  grad_m = g_out[dst] [* 1/deg]          (sorted gather)
#       (grad_xe, grad_e) = vjp of op at edges
#       grad_x = segment_sum_by_src(grad_xe)    (sorted via reverse graph)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _spmm_xe(op: str, reduce: str, exact: bool, g: Graph, x, e):
    msg = _combine(op, _gather_src(g, x), e)
    out = _seg_sum_by_dst(g, msg, exact)
    if reduce == "mean":
        inv = _inv_deg(g, out.dtype)
        out = out * inv.reshape(inv.shape + (1,) * (out.ndim - 1))
    return out


def _spmm_xe_fwd(op, reduce, exact, g, x, e):
    return _spmm_xe(op, reduce, exact, g, x, e), (g, x, e)


def _spmm_xe_bwd(op, reduce, exact, res, g_out):
    g, x, e = res
    if reduce == "mean":
        inv = _inv_deg(g, g_out.dtype)
        g_out = g_out * inv.reshape(inv.shape + (1,) * (g_out.ndim - 1))

    rev = g.reverse
    # grad_x = transpose-SpMM: aggregate the (scaled) output cotangents over
    # the REVERSE graph. For copy_u this is a single fused gather+reduce,
    # one E-length gather instead of gather-then-permute.
    if op in ("copy_u", "copy_lhs"):
        if rev is not None:
            msg = jnp.take(g_out, jnp.minimum(rev.src, rev.num_src_nodes - 1), axis=0)
            grad_x = _seg_sum_by_dst(rev, msg, exact)
        else:
            grad_m = jnp.take(g_out, jnp.minimum(g.dst, g.num_dst_nodes - 1), axis=0)
            grad_x = segment_sum(grad_m, g.src, g.num_src_nodes, sorted=False)
        grad_x = grad_x.astype(x.dtype)
        grad_e = jnp.zeros_like(e)
    else:
        # binary ops: per-edge cotangent in canonical order (needed for
        # grad_e anyway), then reverse-permute for the x scatter.
        xe = _gather_src(g, x)
        msg, vjp = jax.vjp(lambda a, b: _combine(op, a, b), xe, e)
        # the reduction accumulates low-precision messages in f32; the
        # cotangent goes back in the messages' own dtype
        grad_m = gather_dst(g, g_out).astype(msg.dtype)
        grad_xe, grad_e = vjp(grad_m)
        if rev is not None:
            perm = jnp.minimum(rev.eid, g.num_edges_padded - 1)
            grad_xe_rev = jnp.take(grad_xe, perm, axis=0)
            grad_x = _seg_sum_by_dst(rev, grad_xe_rev, exact)
        else:
            grad_x = segment_sum(grad_xe, g.src, g.num_src_nodes, sorted=False)
        grad_x = grad_x.astype(x.dtype)
        # zero padded-edge cotangents so garbage never reaches user edata grads
        mask = g.edge_mask(grad_e.dtype).reshape((-1,) + (1,) * (grad_e.ndim - 1))
        grad_e = (grad_e * mask).astype(e.dtype)

    grad_g = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, jax.dtypes.float0), g
    )
    return grad_g, grad_x, grad_e


_spmm_xe.defvjp(_spmm_xe_fwd, _spmm_xe_bwd)


# -- edge-chunked binary SpMM (bounded live memory) -------------------------
#
# The fused binary path materializes several (E_pad, D) tensors at once in
# its backward (message, cotangent, per-edge grad, reverse-permuted grad) —
# at ogbn-proteins scale (39.5M edges × 32 feats, ×8 relations per layer)
# that can exceed device memory (the reference leans on cuSPARSE streaming
# for the same shape, ``main_dgl_proteins_rgcn_for.py:52``). This variant scans CANONICAL edge
# chunks: each step gathers/combines/reduces one chunk into an (N_dst, D)
# accumulator, so live memory is E_pad/k × D for any k — and the custom VJP
# scans the SAME chunks in backward (recompute instead of residuals).


def _echunk_arrays(g: Graph, e, k: int):
    """Split canonical src/dst/e into k equal chunks (sentinel-padded).

    Edge features are returned FEATURE-MAJOR — (k, F, C), not (k, C, F) —
    so a narrow relation stack (F = 8) keeps the long edge axis minor and
    a layout that tiles the last dim never pads it."""
    E = g.num_edges_padded
    C = -(-E // k)
    pad = k * C - E
    s = jnp.concatenate([g.src, jnp.full((pad,), g.num_src_nodes, g.src.dtype)])
    d = jnp.concatenate([g.dst, jnp.full((pad,), g.num_dst_nodes, g.dst.dtype)])
    f = 1
    for dim in e.shape[1:]:
        f *= dim
    ef = jnp.swapaxes(e.reshape(E, f), 0, 1)  # (F, E)
    if pad:
        ef = jnp.pad(ef, ((0, 0), (0, pad)))
    return (s.reshape(k, C), d.reshape(k, C),
            jnp.swapaxes(ef.reshape(f, k, C), 0, 1), pad)  # (k, F, C)


def _echunk_unstack(ee, e_shape):
    """(F, C) feature-major chunk → (C,) + e.shape[1:] (fuses into the
    consumer combine — no materialized temp)."""
    c = ee.shape[-1]
    return jnp.swapaxes(ee, 0, 1).reshape((c,) + e_shape[1:])


def _echunk_restack(ge_chunks, g: Graph, pad: int, e_shape):
    """Stacked (k, F, C) grads → (E_pad,) + e.shape[1:]."""
    k, f, c = ge_chunks.shape
    ge = jnp.swapaxes(ge_chunks, 0, 1).reshape(f, k * c)
    if pad:
        ge = ge[:, : g.num_edges_padded]
    return jnp.swapaxes(ge, 0, 1).reshape((g.num_edges_padded,) + e_shape[1:])


def _copyu_echunk_sum(g: Graph, x, k: int):
    """Edge-chunked copy_u SUM: lax.scan over canonical edge chunks — each
    chunk gathers (C, D) rows and adds a sorted segment sum (canonical
    order is dst-sorted, so every chunk is internally sorted). ONE pass
    over the E rows total; the feature-chunked alternative gathers all E
    rows once per feature slice."""
    E = g.num_edges_padded
    C = -(-E // k)
    pad = k * C - E
    s = jnp.concatenate([g.src, jnp.full((pad,), g.num_src_nodes, g.src.dtype)])
    d = jnp.concatenate([g.dst, jnp.full((pad,), g.num_dst_nodes, g.dst.dtype)])
    acc0 = jnp.zeros((g.num_dst_nodes,) + x.shape[1:], jnp.promote_types(x.dtype, jnp.float32))

    def body(acc, inp):
        sc, dc = inp
        msg = jnp.take(x, jnp.minimum(sc, g.num_src_nodes - 1), axis=0)
        # sentinel dst == num_dst_nodes is out of range → dropped
        return acc + segment_sum(msg.astype(acc.dtype), dc, g.num_dst_nodes,
                                 sorted=True), None

    out, _ = jax.lax.scan(body, acc0, (s.reshape(k, C), d.reshape(k, C)))
    return out


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _spmm_copyu_echunk(reduce: str, k: int, g: Graph, x):
    out = _copyu_echunk_sum(g, x, k)
    if reduce == "mean":
        out = out * _inv_deg(g, out.dtype)[:, None]
    return out.astype(jnp.promote_types(x.dtype, jnp.float32))


def _spmm_copyu_echunk_fwd(reduce, k, g, x):
    return _spmm_copyu_echunk(reduce, k, g, x), (g, jnp.zeros((0,), x.dtype))


def _spmm_copyu_echunk_bwd(reduce, k, res, g_out):
    # adjoint of copy_u-sum is the SAME edge-chunked pass over the
    # transpose graph (reverse canonical order is sorted by original src)
    g, dtype_token = res
    if reduce == "mean":
        g_out = g_out * _inv_deg(g, g_out.dtype)[:, None]
    grad_x = _copyu_echunk_sum(g.reverse, g_out, k)
    grad_g = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, jax.dtypes.float0), g
    )
    return grad_g, grad_x.astype(dtype_token.dtype)


_spmm_copyu_echunk.defvjp(_spmm_copyu_echunk_fwd, _spmm_copyu_echunk_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _spmm_xe_echunk(op: str, reduce: str, k: int, g: Graph, x, e):
    srcs, dsts, es, _ = _echunk_arrays(g, e, k)
    out_shape = jnp.broadcast_shapes(x.shape[1:], e.shape[1:])
    acc0 = jnp.zeros((g.num_dst_nodes,) + out_shape, jnp.promote_types(x.dtype, e.dtype))

    def body(acc, inp):
        s, d, ee = inp
        msg = _combine(op, jnp.take(x, jnp.minimum(s, g.num_src_nodes - 1), axis=0),
                       _echunk_unstack(ee, e.shape))
        # sentinel dst == num_dst_nodes is out of range → dropped
        return acc + segment_sum(msg, d, g.num_dst_nodes, sorted=False), None

    out, _ = jax.lax.scan(body, acc0, (srcs, dsts, es))
    if reduce == "mean":
        inv = _inv_deg(g, out.dtype)
        out = out * inv.reshape(inv.shape + (1,) * (out.ndim - 1))
    return out


def _spmm_xe_echunk_fwd(op, reduce, k, g, x, e):
    return _spmm_xe_echunk(op, reduce, k, g, x, e), (g, x, e)


def _spmm_xe_echunk_bwd(op, reduce, k, res, g_out):
    g, x, e = res
    if reduce == "mean":
        inv = _inv_deg(g, g_out.dtype)
        g_out = g_out * inv.reshape(inv.shape + (1,) * (g_out.ndim - 1))
    srcs, dsts, es, pad = _echunk_arrays(g, e, k)
    gx0 = jnp.zeros(x.shape, g_out.dtype)

    def body(gx, inp):
        s, d, ee = inp
        grad_m = jnp.take(g_out, jnp.minimum(d, g.num_dst_nodes - 1), axis=0)
        # zero sentinel-edge cotangents HERE: their clamped gather reads a
        # real row, and grad_e is emitted per chunk (can't mask afterwards
        # without re-materializing full E)
        mask = (d < g.num_dst_nodes).reshape((-1,) + (1,) * (grad_m.ndim - 1))
        grad_m = grad_m * mask.astype(grad_m.dtype)
        xe = jnp.take(x, jnp.minimum(s, g.num_src_nodes - 1), axis=0)
        _, vjp = jax.vjp(
            lambda a, b: _combine(op, a, _echunk_unstack(b, e.shape)), xe, ee)
        grad_xe, grad_e = vjp(grad_m)
        gx = gx + segment_sum(grad_xe, s, x.shape[0], sorted=False)
        return gx, grad_e  # grad_e back in (F, C) feature-major layout

    grad_x, ge_chunks = jax.lax.scan(body, gx0, (srcs, dsts, es))
    grad_e = _echunk_restack(ge_chunks, g, pad, e.shape)
    grad_g = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, jax.dtypes.float0), g
    )
    return grad_g, grad_x.astype(x.dtype), grad_e.astype(e.dtype)


_spmm_xe_echunk.defvjp(_spmm_xe_echunk_fwd, _spmm_xe_echunk_bwd)


# -- relation-contracted SpMM (RGCN fast path) -------------------------------
#
# out[v] = Σ_{e=(u,v)} Σ_r w[e,r] · y[u,r,:]
#
# The RGCN-for-proteins layer (``main_dgl_proteins_rgcn_for.py:44-60``) is
# Σ_r mean_by_dst(x·w_r) @ W_r; since per-edge weights are scalars and W_r
# is linear they commute, so projecting FIRST (y_r = x @ W_r, one batched
# matmul) turns 8 separate gather+scatter passes into ONE pass that
# gathers the (R·D)-wide stacked projection and contracts the relation dim
# per edge — 8× fewer row gathers. Edge-chunked
# (lax.scan) with a custom VJP so live memory stays (E/k, R, D).


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def gspmm_rel(reduce: str, k: int, g: Graph, y, w):
    """Relation-contracted SpMM. y: (N_src, R, D); w: (E_pad, R) canonical.

    Returns (N_dst, D): ``reduce_by_dst(einsum('erd,er->ed', y[src], w))``
    with mean dividing by the shared in-degree (DGL ``fn.mean`` semantics,
    zero rows for zero in-degree).
    """
    srcs, dsts, ws, _ = _echunk_arrays(g, w, k)
    n_rel, dd = y.shape[1], y.shape[2]
    # gather the FLAT (N, R·D) projection; the static-R contraction loop
    # below fuses its slices into the multiply-adds
    y2 = y.reshape(y.shape[0], n_rel * dd)
    acc0 = jnp.zeros((g.num_dst_nodes, dd), jnp.promote_types(y.dtype, w.dtype))

    def body(acc, inp):
        s, d, ee = inp  # ee: (R, C) feature-major
        ye = jnp.take(y2, jnp.minimum(s, g.num_src_nodes - 1), axis=0)
        msg = sum(
            ye[:, r * dd : (r + 1) * dd] * ee[r][:, None].astype(ye.dtype)
            for r in range(n_rel)
        )
        return acc + segment_sum(msg, d, g.num_dst_nodes, sorted=False), None

    out, _ = jax.lax.scan(body, acc0, (srcs, dsts, ws))
    if reduce == "mean":
        inv = _inv_deg(g, out.dtype)
        out = out * inv[:, None]
    return out


def _gspmm_rel_fwd(reduce, k, g, y, w):
    return gspmm_rel(reduce, k, g, y, w), (g, y, w)


def _gspmm_rel_bwd(reduce, k, res, g_out):
    g, y, w = res
    if reduce == "mean":
        g_out = g_out * _inv_deg(g, g_out.dtype)[:, None]
    srcs, dsts, ws, pad = _echunk_arrays(g, w, k)
    n_rel, dd = y.shape[1], y.shape[2]
    y2 = y.reshape(y.shape[0], n_rel * dd)
    gy0 = jnp.zeros(y2.shape, g_out.dtype)

    def body(gy, inp):
        s, d, ee = inp  # ee: (R, C) feature-major
        grad_m = jnp.take(g_out, jnp.minimum(d, g.num_dst_nodes - 1), axis=0)
        grad_m = grad_m * (d < g.num_dst_nodes)[:, None].astype(grad_m.dtype)
        ye = jnp.take(y2, jnp.minimum(s, g.num_src_nodes - 1), axis=0)
        grad_w = jnp.stack([
            jnp.sum(ye[:, r * dd : (r + 1) * dd].astype(grad_m.dtype) * grad_m,
                    axis=1)
            for r in range(n_rel)
        ])  # (R, C) feature-major
        grad_ye = jnp.concatenate(
            [grad_m * ee[r][:, None].astype(grad_m.dtype) for r in range(n_rel)],
            axis=1)  # (C, R·D) flat
        gy = gy + segment_sum(grad_ye, s, y.shape[0], sorted=False)
        return gy, grad_w

    grad_y, gw_chunks = jax.lax.scan(body, gy0, (srcs, dsts, ws))
    grad_y = grad_y.reshape(y.shape)
    grad_w = _echunk_restack(gw_chunks, g, pad, w.shape)
    grad_g = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, jax.dtypes.float0), g
    )
    return grad_g, grad_y.astype(y.dtype), grad_w.astype(w.dtype)


gspmm_rel.defvjp(_gspmm_rel_fwd, _gspmm_rel_bwd)


def gspmm(
    g: Graph,
    op: str,
    reduce: str,
    x: Optional[jnp.ndarray] = None,
    e: Optional[jnp.ndarray] = None,
    *,
    exact: bool = False,
) -> jnp.ndarray:
    """Generalized SpMM (see module docstring).

    Args:
      g: graph (edges canonical/dst-sorted).
      op: message op; ``copy_u``/``copy_lhs`` uses only ``x``,
        ``copy_e``/``copy_rhs`` only ``e``, the rest combine both with numpy
        broadcasting (e.g. x (E,H,D) with e (E,H,1) for attention).
      reduce: ``sum`` | ``mean`` | ``max`` | ``min``.
      x: (num_src_nodes, ...) source-node features.
      e: (E_pad, ...) edge features in canonical order.
      exact: force the bitwise-faithful sorted-scatter reduction regardless
        of the global scan/blocked mode (one-time precomputes).
    Returns:
      (num_dst_nodes, ...) aggregated features.
    """
    if op not in _BINARY_WITH_X and op not in _BINARY_WITH_E:
        raise ValueError(f"unknown spmm op: {op!r}")
    if reduce not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown spmm reduce: {reduce!r}")
    needs_x = op in _BINARY_WITH_X
    needs_e = op in _BINARY_WITH_E
    if needs_x and x is None:
        raise ValueError(f"spmm op {op!r} requires node features x")
    if needs_e and e is None:
        raise ValueError(f"spmm op {op!r} requires edge features e")

    if (
        os.environ.get("DGL_JAX_LOWERING") == "scatter"
        and reduce in ("sum", "mean")
        and not exact
    ):
        # PyG-twin lowering (reference N10/K2, README.md:72): materialize the
        # (E, ...) message via explicit gathers and reduce with the plain
        # segment op — NO custom VJP, no reverse-graph routing, no edge/
        # feature chunking. AD differentiates the gather into an unsorted
        # scatter-add, exactly the cost profile torch_scatter gives PyG.
        # Drivers expose this as --lowering scatter so the fused-vs-scatter
        # design tension is reproducible at workload level (the reference
        # measured DGL losing ~10% to PyG on molhiv at ~1:1 node:edge).
        if needs_x:
            xe = _gather_src(g, x)
            msg = _combine(op, xe, e) if needs_e else xe
        else:
            msg = e
        out = segment_sum(msg, g.dst, g.num_dst_nodes, sorted=True)
        if reduce == "mean":
            inv = _inv_deg(g, out.dtype)
            out = out * inv.reshape(inv.shape + (1,) * (out.ndim - 1))
        return out

    if os.environ.get("DGL_JAX_FAULT_ZERO_AGG"):
        # deliberate fault injection (test-only): zero every aggregation so
        # the hardened structure-required e2e gates demonstrably FAIL when
        # message passing is broken. Never set in production.
        ref = x if needs_x else e
        shape = (g.num_dst_nodes,) + tuple(ref.shape[1:])
        return jnp.zeros(shape, ref.dtype if ref.dtype != jnp.int32 else jnp.float32)

    if (
        g.block_fanout is not None
        and op in ("copy_u", "copy_lhs")
        and reduce in ("sum", "mean", "max", "min")
    ):
        # positional sampled block: edge (i, j)'s source is slot
        # num_dst + i*fanout + j, so aggregation is a pure reshape-reduce —
        # zero gather/scatter (and its AD is a reshape-broadcast).
        f = g.block_fanout
        nd = g.num_dst_nodes
        neigh = x[nd : nd + nd * f].reshape((nd, f) + x.shape[1:])
        return {
            "sum": jnp.sum, "mean": jnp.mean, "max": jnp.max, "min": jnp.min
        }[reduce](neigh, axis=1)
    if (
        op in ("copy_u", "copy_lhs")
        and reduce in ("sum", "mean")
        and x is not None
        and x.ndim == 2
    ):
        # copy_u messages that exceed the budget are EDGE-chunked: the scan
        # gathers every edge row exactly once (live set E/k × D both
        # directions via the reverse-graph adjoint), where a feature-chunked
        # formulation would gather all E rows once per feature slice.
        budget = msg_budget_bytes()
        d = x.shape[1]
        bytes_full = g.num_edges_padded * d * x.dtype.itemsize
        if bytes_full > budget and d > 1:
            if not exact and g.reverse is not None:
                k = int(-(-bytes_full // (budget / 2)))
                return _spmm_copyu_echunk(reduce, k, g, x)
            # exact callers (one-time precomputes) keep the bitwise-stable
            # feature-sliced formulation: k_f sequential row passes, each a
            # full sorted scatter (slow — but cached, and never in a step)
            chunk = max(1, int(d * budget / bytes_full))
            n_chunks = -(-d // chunk)
            d_pad = n_chunks * chunk
            xp = jnp.pad(x, ((0, 0), (0, d_pad - d)))
            xstack = jnp.moveaxis(xp.reshape(x.shape[0], n_chunks, chunk), 1, 0)
            zero_e = jnp.zeros((), x.dtype)
            outs = jax.lax.map(
                lambda xc: _spmm_xe(op, reduce, exact, g, xc, zero_e), xstack
            )
            return jnp.moveaxis(outs, 0, 1).reshape(g.num_dst_nodes, d_pad)[:, :d]
    if needs_x and needs_e and reduce in ("sum", "mean"):
        # binary ops build (E_pad, D) messages; the BACKWARD holds ~4 of
        # them live (cotangent, xe, grad_xe, reverse-permuted grad_xe), so
        # chunk edges when the full message exceeds 1/4 of the budget
        budget = msg_budget_bytes()
        out_shape = jnp.broadcast_shapes(x.shape[1:], e.shape[1:] if e.ndim else ())
        numel = 1
        for dim in out_shape:
            numel *= dim
        bytes_full = g.num_edges_padded * numel * jnp.promote_types(x.dtype, e.dtype).itemsize
        if bytes_full > budget / 4 and e.ndim:
            k = int(-(-bytes_full // (budget / 4)))
            return _spmm_xe_echunk(op, reduce, k, g, x, e)
        return _spmm_xe(op, reduce, exact, g, x, e)
    if needs_x and not needs_e and reduce in ("sum", "mean"):
        # reuse the custom-VJP path with a scalar dummy edge operand
        dummy = jnp.zeros((), dtype=x.dtype)
        return _spmm_xe("copy_u", reduce, exact, g, x, dummy)

    # max/min and copy_e paths: plain ops; AD of these is already efficient
    # (copy_e backward is a sorted gather; max/min route grads via argmax).
    if needs_x:
        xe = _gather_src(g, x)
        msg = _combine(op, xe, e) if needs_e else xe
    else:
        msg = e
        if reduce in ("max", "min"):
            # mask padded edges so they never win the extremum
            fill = -jnp.inf if reduce == "max" else jnp.inf
            m = g.edge_mask(jnp.bool_).reshape((-1,) + (1,) * (msg.ndim - 1))
            msg = jnp.where(m, msg, fill)
    return _reduce(g, msg, reduce, exact)


def gspmm_chunked(
    g: Graph, op: str, reduce: str, x: jnp.ndarray, chunk: int = 64
) -> jnp.ndarray:
    """SpMM over wide features, chunked along the feature dim (host loop).

    The fused spmm materializes an (E_pad, D) message tensor; for wide inputs
    (e.g. the one-time layer-1 precompute on reddit: 11.6M × 602 × 4B = 28GB)
    that exceeds HBM. Chunking bounds the intermediate at E_pad × chunk.

    Used for one-time precomputes, so it forces the exact scatter reduction
    (the scan path trades ~4e-3 mean relative error on positive data for
    speed — fine per-step, not for a cached constant).
    """
    outs = []
    f = jax.jit(lambda g, xc: gspmm(g, op, reduce, x=xc, exact=True))
    for lo in range(0, x.shape[-1], chunk):
        outs.append(f(g, x[:, lo : lo + chunk]))
    return jnp.concatenate(outs, axis=-1)


# -- convenience aliases (the hot paths) -----------------------------------


def copy_u_sum(g: Graph, x):
    return gspmm(g, "copy_u", "sum", x=x)


def copy_u_mean(g: Graph, x):
    return gspmm(g, "copy_u", "mean", x=x)


def u_mul_e_sum(g: Graph, x, e):
    return gspmm(g, "mul", "sum", x=x, e=e)
