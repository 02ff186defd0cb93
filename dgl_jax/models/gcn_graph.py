"""GCN graph-classification networks (ENZYMES + OGB mol variants).

Parity targets:
* ``main_dgl_enzymes_gcn.py:41-89`` — N conv layers with BN+relu+dropout
  between, mean-pool readout, 2 MLP layers, log_softmax output.
* ``main_dgl_molhiv_gcn.py:54-89`` / ``main_dgl_ppa_gcn.py`` — AtomEncoder
  (or embedding) input, per-layer edge encoders inside GCNConvEdge
  semantics, BN+relu+dropout between, mean-pool readout, linear head.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from ..nn import linen as nn

from ..graph.batch import GraphBatch, readout
from ..nn import (
    AtomEncoder,
    BondEncoder,
    GCNConv,
    GCNConvEdge,
    MaskedBatchNorm,
    relu_gain,
    xavier_uniform,
)


class GCNGraphClassifier(nn.Module):
    """ENZYMES-style: plain sym-norm GCN stack + mean readout + 2-layer MLP."""

    hidden_feats: int
    num_classes: int
    num_layers: int = 4
    dropout: float = 0.5

    @nn.compact
    def __call__(self, batch: GraphBatch, x: jnp.ndarray, *, deterministic: bool = True):
        g = batch.graph
        node_mask = (batch.node_gid < batch.num_graphs).astype(x.dtype)
        for i in range(self.num_layers - 1):
            x = GCNConv(self.hidden_feats, name=f"conv_{i}")(g, x)
            x = MaskedBatchNorm(name=f"bn_{i}")(
                x, node_mask, use_running_average=deterministic
            )
            x = nn.relu(x)
            x = nn.Dropout(self.dropout, deterministic=deterministic)(x)
        x = GCNConv(self.hidden_feats, name=f"conv_{self.num_layers - 1}")(g, x)
        xg = readout(batch, x, "mean")
        init = xavier_uniform(relu_gain())
        xg = nn.Dense(self.hidden_feats, kernel_init=init, name="graph_fc_0")(xg)
        xg = nn.relu(xg)
        xg = nn.Dropout(self.dropout, deterministic=deterministic)(xg)
        xg = nn.Dense(self.num_classes, kernel_init=init, name="graph_fc_1")(xg)
        return jax.nn.log_softmax(xg, axis=-1)


class GCNMolClassifier(nn.Module):
    """OGB mol-style: encoders + edge-feature GCN stack + mean readout.

    ``node_encoder``: 'atom' (AtomEncoder) or 'embed' (single shared
    embedding, the ppa variant ``main_dgl_ppa_gcn.py:61``).
    ``edge_encoder``: 'bond' (per-layer BondEncoder) or an int — input edge
    feature width for a per-layer Linear (ppa uses Linear(7, emb)).
    """

    emb_dim: int
    num_classes: int
    num_layers: int = 5
    dropout: float = 0.5
    node_encoder: str = "atom"
    edge_encoder: str | int = "bond"

    @nn.compact
    def __call__(
        self,
        batch: GraphBatch,
        atom: jnp.ndarray,  # (N_pad, 9) int or anything for 'embed'
        bond: jnp.ndarray,  # (E_pad, 3) int canonical order (or (E_pad, F) float)
        *,
        deterministic: bool = True,
    ):
        g = batch.graph
        node_mask = (batch.node_gid < batch.num_graphs).astype(jnp.float32)
        if self.node_encoder == "atom":
            x = AtomEncoder(self.emb_dim, name="atom_encoder")(atom)
        elif self.node_encoder == "embed":
            w = self.param("node_emb", nn.initializers.xavier_uniform(), (1, self.emb_dim))
            x = jnp.broadcast_to(w, (g.num_dst_nodes, self.emb_dim))
        else:
            raise ValueError(self.node_encoder)

        for i in range(self.num_layers):
            if self.edge_encoder == "bond":
                w_edge = BondEncoder(self.emb_dim, name=f"bond_encoder_{i}")(bond)
            else:
                w_edge = nn.Dense(self.emb_dim, name=f"edge_fc_{i}")(bond)
            x = GCNConvEdge(self.emb_dim, name=f"conv_{i}")(g, x, w_edge)
            if i < self.num_layers - 1:
                x = MaskedBatchNorm(name=f"bn_{i}")(
                    x, node_mask, use_running_average=deterministic
                )
                x = nn.relu(x)
                x = nn.Dropout(self.dropout, deterministic=deterministic)(x)
        xg = readout(batch, x, "mean")
        return nn.Dense(
            self.num_classes, use_bias=False, kernel_init=xavier_uniform(relu_gain()),
            name="graph_pred_fc",
        )(xg)
