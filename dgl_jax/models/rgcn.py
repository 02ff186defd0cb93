"""RGCN network for ogbn-proteins (parity: ``main_dgl_proteins_rgcn_for.py:62-109``)."""

from __future__ import annotations

import jax.numpy as jnp
from ..nn import linen as nn

from ..graph.graph import Graph
from ..nn import RelGraphConv


class RGCN(nn.Module):
    hidden_feats: int
    out_feats: int
    num_relations: int
    num_layers: int = 3
    dropout: float = 0.0
    fuse_relations: bool = False

    @nn.compact
    def __call__(
        self,
        g: Graph,
        x: jnp.ndarray,
        edge_weights: jnp.ndarray,  # (E_pad, R) canonical order
        *,
        deterministic: bool = True,
    ):
        for i in range(self.num_layers):
            last = i == self.num_layers - 1
            x = RelGraphConv(
                out_feats=self.out_feats if last else self.hidden_feats,
                num_relations=self.num_relations,
                activation=None if last else nn.relu,
                dropout=0.0 if last else self.dropout,
                fuse_relations=self.fuse_relations,
                name=f"rgcn_{i}",
            )(g, x, edge_weights, deterministic=deterministic)
        return x
