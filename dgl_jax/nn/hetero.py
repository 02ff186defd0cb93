"""Heterogeneous graph convolution: per-relation conv + cross-relation reduce.

Equivalent of ``dgl.nn.HeteroGraphConv`` as used by GCMC
(``gcmc_dgl/model.py:205``): fan out one conv per edge type, group outputs
by destination node type, combine with stack/sum/mean/max/min. The relation
loop is static and unrolls into one XLA program.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import jax.numpy as jnp
from . import linen as nn

from ..graph.hetero import EType, HeteroGraph

__all__ = ["HeteroGraphConv"]


def _combine(agg: str, outs):
    if agg == "stack":
        return jnp.stack(outs, axis=1)  # (N, R, D)
    if agg == "sum":
        return sum(outs)
    if agg == "mean":
        return sum(outs) / len(outs)
    if agg == "max":
        out = outs[0]
        for o in outs[1:]:
            out = jnp.maximum(out, o)
        return out
    if agg == "min":
        out = outs[0]
        for o in outs[1:]:
            out = jnp.minimum(out, o)
        return out
    raise ValueError(f"unknown cross-relation agg: {agg!r}")


class HeteroGraphConv(nn.Module):
    """Apply a conv per relation and combine per destination node type.

    Attributes:
      convs: {relation_name: module}; the module is called as
        ``conv(g_rel, (x_src, x_dst), **kwargs)``.
      agg: cross-relation reducer ('stack' | 'sum' | 'mean' | 'max' | 'min').

    ``__call__(hg, feats, mod_kwargs=None)`` where ``feats`` maps node type →
    features; returns {node_type: combined features} (stack produces
    (N, R_dst, D), matching DGL's stack semantics).
    """

    convs: Mapping[str, nn.Module]
    agg: str = "stack"

    @nn.compact
    def __call__(
        self,
        hg: HeteroGraph,
        feats: Mapping[str, jnp.ndarray],
        mod_kwargs: Optional[Mapping[str, Dict[str, Any]]] = None,
    ) -> Dict[str, jnp.ndarray]:
        mod_kwargs = mod_kwargs or {}
        by_dst: Dict[str, list] = {}
        for (stype, rel, dtype) in hg.etypes:
            if rel not in self.convs:
                continue
            g = hg[(stype, rel, dtype)]
            out = self.convs[rel](
                g, (feats[stype], feats[dtype]), **mod_kwargs.get(rel, {})
            )
            by_dst.setdefault(dtype, []).append(out)
        return {nt: _combine(self.agg, outs) for nt, outs in by_dst.items()}
