"""Edge-side gathers.

``gather_dst(g, v)`` produces ``v[dst[e]]`` for every edge. By default this
is a row gather. On a dst-sorted graph it is also a repeat-interleave by
in-degree, which can be computed WITHOUT a per-edge gather: scatter
first-differences of ``v`` at the row starts (``indptr``, an N-row scatter)
and prefix-scan over edges. ``DGL_JAX_SEGSUM=cumsum`` selects that scan
formulation (``segment.use_scan_reductions``).

Telescoping handles zero-degree nodes: several rows sharing one indptr
position accumulate their diffs, so the running sum at edge ``e`` is exactly
``v[owner(e)]``.

``gather_src`` has no such structure (src is unordered) and stays a row
gather.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..graph.graph import Graph
from .segment import use_scan_reductions

__all__ = ["gather_dst", "gather_src", "gather_src_rows", "spread_dst",
           "seg_sum_dst"]


def gather_src(g: Graph, x):
    """x[src[e]] — per-edge source gather (row-bound)."""
    return jnp.take(x, jnp.minimum(g.src, g.num_src_nodes - 1), axis=0)


@partial(jax.custom_vjp, nondiff_argnums=())
def gather_src_rows(g: Graph, x):
    """Differentiable src gather whose backward is a SINGLE row-op.

    Plain AD of a gather emits an unsorted scatter-add; this VJP permutes
    the edge cotangents into the reverse graph's order (one row gather) and
    finishes with a sorted reduction. Share ONE gather_src_rows result
    across every consumer of ``x[src]`` in a layer (e.g. GAT uses it for
    both attention logits and the weighted aggregation) so the whole layer
    pays exactly one row-op per direction.
    """
    return gather_src(g, x)


def _gsr_fwd(g, x):
    return gather_src(g, x), (g,)


def _gsr_bwd(res, ge):
    (g,) = res
    rev = g.reverse
    if rev is not None:
        perm = jnp.minimum(rev.eid, g.num_edges_padded - 1)
        ge_rev = jnp.take(ge, perm, axis=0)  # the single backward row-op
        from .spmm import _seg_sum_by_dst

        grad_x = _seg_sum_by_dst(rev, ge_rev)
    else:
        grad_x = jax.ops.segment_sum(ge, g.src, num_segments=g.num_src_nodes)
    grad_g = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, jax.dtypes.float0), g
    )
    return grad_g, grad_x.astype(ge.dtype)


gather_src_rows.defvjp(_gsr_fwd, _gsr_bwd)


def gather_dst(g: Graph, v):
    """v[dst[e]] for valid edges (padding tail carries the last value —
    callers must treat padded rows as garbage, as with every edge op)."""
    if not use_scan_reductions():
        return jnp.take(v, jnp.minimum(g.dst, g.num_dst_nodes - 1), axis=0)
    e_pad = g.num_edges_padded
    diffs = jnp.concatenate([v[:1], v[1:] - v[:-1]], axis=0)  # (N, ...)
    z = jnp.zeros((e_pad,) + v.shape[1:], v.dtype)
    # drop out-of-range starts (trailing zero-degree nodes when the edge
    # array is exactly full) instead of clamping — clamping would corrupt
    # the final edge slot
    z = z.at[g.indptr[:-1]].add(diffs, indices_are_sorted=True, mode="drop")
    return jnp.cumsum(z, axis=0, dtype=v.dtype)


# -- Differentiable dst-side spread / reduce duals --------------------------
#
# ``spread_dst``/``seg_sum_dst`` are exact adjoints of each other:
# d/dv Σ_e f(v[dst[e]]) routes each edge cotangent back to its dst node
# (a sorted segment sum), and vice versa. Registering them as a custom-VJP
# pair keeps BOTH directions on the scan formulations — plain AD of the
# scan-based gather_dst emits cumsum+scatter adjoint chains, and AD of a
# scatter-based segment_sum emits a per-row E-gather.


@jax.custom_vjp
def spread_dst(g: Graph, v):
    """Differentiable ``v[dst[e]]`` whose backward is one sorted
    segment-sum (the mathematical adjoint), not AD of the scan gather."""
    return gather_dst(g, v)


def _spread_fwd(g, v):
    # zero-size token: the backward returns the cotangent in v's dtype
    return gather_dst(g, v), (g, jnp.zeros((0,), v.dtype))


def _spread_bwd(res, ge):
    g, token = res
    from .spmm import _seg_sum_by_dst

    grad_v = _seg_sum_by_dst(g, ge)
    grad_g = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, jax.dtypes.float0), g
    )
    return grad_g, grad_v.astype(token.dtype)


spread_dst.defvjp(_spread_fwd, _spread_bwd)


@jax.custom_vjp
def seg_sum_dst(g: Graph, msg):
    """Differentiable sorted segment-sum over dst whose backward is one
    scan-based dst spread (the adjoint), not AD of the blocked reduction."""
    from .spmm import _seg_sum_by_dst

    return _seg_sum_by_dst(g, msg)


def _ssd_fwd(g, msg):
    # the sum of low-precision messages comes out in f32; the zero-size
    # token lets the backward return the cotangent in msg's own dtype
    return seg_sum_dst(g, msg), (g, jnp.zeros((0,), msg.dtype))


def _ssd_bwd(res, gout):
    g, token = res
    grad_msg = gather_dst(g, gout)
    grad_g = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, jax.dtypes.float0), g
    )
    return grad_g, grad_msg.astype(token.dtype)


seg_sum_dst.defvjp(_ssd_fwd, _ssd_bwd)
