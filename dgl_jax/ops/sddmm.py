"""g-SDDMM: per-edge binary op on endpoint features.

Equivalent of ``dgl.ops.gsddmm`` (benchmarked at
``kernel/dgl-new.py:39``) and of ``g.apply_edges(fn.u_dot_v(...))``
(``gcmc_dgl/model.py:342``, ``cluster_gcn_dgl.py:94``). The PyG twin spells
the same computation as explicit gathers (``kernel/pyg.py:47-49``) — that
*is* the right lowering (two row gathers + an elementwise op), so this is
plain XLA; fusion happens in the compiler.

Semantics: for every edge ``e = (u, v)``::

    out[e] = op(lhs[u], rhs[v])

with ``op`` ∈ {add, sub, mul, div, dot, copy_u, copy_v}. Outputs are in
canonical (dst-sorted) edge order with padded entries zeroed.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from ..graph.graph import Graph
from .gather import gather_dst, gather_src

__all__ = ["gsddmm", "u_dot_v", "u_mul_v"]


def gsddmm(
    g: Graph,
    op: str,
    u: Optional[jnp.ndarray] = None,
    v: Optional[jnp.ndarray] = None,
    *,
    mask_padding: bool = True,
) -> jnp.ndarray:
    """Generalized SDDMM (see module docstring).

    Args:
      u: (num_src_nodes, ...) features gathered at edge sources.
      v: (num_dst_nodes, ...) features gathered at edge destinations.
      mask_padding: zero out padded-edge outputs (set False when the result
        feeds straight into an op that drops padding anyway, e.g. gspmm).
    Returns: (E_pad, ...) edge values, canonical order.
    """
    if op in ("copy_u", "copy_lhs"):
        out = gather_src(g, u)
    elif op in ("copy_v", "copy_rhs"):
        out = gather_dst(g, v)
    else:
        ue = gather_src(g, u)
        ve = gather_dst(g, v)
        if op == "add":
            out = ue + ve
        elif op == "sub":
            out = ue - ve
        elif op == "mul":
            out = ue * ve
        elif op == "div":
            out = ue / ve
        elif op == "dot":
            out = jnp.sum(ue * ve, axis=-1, keepdims=True)
        else:
            raise ValueError(f"unknown sddmm op: {op}")
    if mask_padding:
        m = g.edge_mask(out.dtype).reshape((-1,) + (1,) * (out.ndim - 1))
        out = out * m
    return out


def u_dot_v(g: Graph, u, v):
    """Per-edge dot product — the reference's edge scorer
    (``fn.u_dot_v``, ``cluster_gcn_dgl.py:94``)."""
    return gsddmm(g, "dot", u, v)


def u_mul_v(g: Graph, u, v):
    return gsddmm(g, "mul", u, v)
