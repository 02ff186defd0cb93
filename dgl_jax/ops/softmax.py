"""Edge softmax — numerically stable softmax over in-edges of each node.

Equivalent of DGL's ``edge_softmax`` (the core of every GAT
workload: N5–N7, S3, S4, S6 in SURVEY §2.1; the math is spelled out in the
PyG twin ``main_pyg_arxiv_gat.py:103-105``): per destination node ``v``::

    alpha[e] = exp(z[e] - max_{e'→v} z[e']) / sum_{e'→v} exp(...)

Composed from a sorted segment-max (SDDMM-style), an exp, a sorted
segment-sum and a gather — exactly the decomposition DGL fuses natively; XLA
fuses the elementwise stages.

Padded edges produce garbage alpha values but are dropped by the downstream
scatter (their dst is the out-of-range sentinel); apply ``g.edge_mask`` if
the raw values are consumed directly.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..graph.graph import Graph
from .gather import gather_dst, seg_sum_dst, spread_dst
import jax

__all__ = ["edge_softmax"]


def edge_softmax(g: Graph, logits: jnp.ndarray, dst_bound=None) -> jnp.ndarray:
    """Softmax of (E_pad, ...) edge logits grouped by destination node.

    Trailing dims (e.g. attention heads) are independent.

    ``dst_bound`` (optional, (N_dst, ...) matching the trailing dims) is a
    per-destination UPPER BOUND on the incoming-edge logits. When given,
    the exact segment-max scatter is skipped: softmax is shift-invariant,
    so any bound ≥ the true max is numerically safe (`exp(z - bound) ≤ 1`).
    Callers with structured logits can derive one in O(N) — GATConv passes
    ``leaky_relu(max(a_src) + a_dst)``. Bound looseness only costs
    underflow headroom (f32 exp underflows ~88 below the shift), not
    correctness: rows whose denominator falls too low take the exact path.
    """
    n = g.num_dst_nodes
    # mask padded logits to -inf so they never affect the max
    m = g.edge_mask(jnp.bool_).reshape((-1,) + (1,) * (logits.ndim - 1))
    if dst_bound is None:
        z = jnp.where(m, logits, -jnp.inf)
        seg_max = jax.ops.segment_max(
            z, g.dst, num_segments=n, indices_are_sorted=True
        )
        seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    else:
        db = jnp.asarray(dst_bound)
        db = db.reshape(db.shape + (1,) * (logits.ndim - db.ndim))
        seg_max = jnp.broadcast_to(db, (n,) + logits.shape[1:]).astype(logits.dtype)
    # the shift is a softmax-invariant constant: stop-gradient prunes the
    # whole max/bound branch from the backward pass
    # NOTE: no minimum(…, 0) clamp — the bound is a true upper bound, so
    # shifted ≤ 0 up to rounding, and a clamp would route the gradient of
    # exactly-attained edges (the global-argmax node's out-edges) into the
    # constant arm, corrupting d loss/d logits there.
    seg_max = jax.lax.stop_gradient(seg_max)
    shifted = jnp.where(m, logits - gather_dst(g, seg_max), -jnp.inf)
    expz = jnp.exp(shifted)
    # reduce/spread custom-VJP pair: each direction's adjoint is the other
    # (ops/gather.py)
    denom = seg_sum_dst(g, expz)
    denom = spread_dst(g, denom)
    tiny = jnp.finfo(expz.dtype).tiny
    if dst_bound is None:
        # exact shift: every non-empty destination has one edge at
        # shifted == 0, so denom >= 1 and the quotient backward is safe
        return expz / jnp.maximum(denom, tiny)

    # Loose-bound guard: a bound far above a
    # destination's true in-edge max shrinks that row's denom toward 0.
    # TWO failure modes, not one:
    #   * looseness > ~88: every exp underflows, denom == 0, the clamp
    #     returns silent all-zero attention;
    #   * looseness > ~22 already: denom < ~1e-10 and the quotient-rule
    #     BACKWARD carries 1/denom^2, which overflows f32 (inf * 0 = NaN)
    #     once denom < ~1e-19 — cora GAT (feat_drop 0.6 widens the logit
    #     spread to ~55) NaN'd its params in the FIRST backward.
    # Rescue well before either wall: any live denom <= 1e-12 re-runs the
    # exact segment-max formulation; the clamp at the same eps keeps the
    # backward finite for rows that pass the check.
    eps = jnp.asarray(1e-12, expz.dtype)
    bad = jnp.any(m & (denom <= eps))

    def _exact(operand):
        lg, mm = operand
        z = jnp.where(mm, lg, -jnp.inf)
        sm = jax.ops.segment_max(z, g.dst, num_segments=n,
                                 indices_are_sorted=True)
        sm = jax.lax.stop_gradient(
            jnp.where(jnp.isfinite(sm), sm, 0.0))
        sh = jnp.where(mm, lg - gather_dst(g, sm), -jnp.inf)
        ez = jnp.exp(sh)
        dn = spread_dst(g, seg_sum_dst(g, ez))
        return ez / jnp.maximum(dn, tiny)

    def _loose(operand):
        del operand
        return expz / jnp.maximum(denom, eps)

    return jax.lax.cond(bad, _exact, _loose, (logits, m))
