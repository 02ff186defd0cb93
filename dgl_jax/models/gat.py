"""GAT networks.

Architecture parity target: ``main_dgl_citation_gat.py:14-64`` — first layer
without feat/attn dropout, hidden layers with elu activation and head
concat, output layer averages heads. Works over one graph or per-layer
sampled blocks (``ns-gat-dgl.py:22-60``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import jax.numpy as jnp
from ..nn import linen as nn

from ..nn import GATConv


class GAT(nn.Module):
    hidden_feats: int
    out_feats: int
    heads: Sequence[int]  # one entry per layer, e.g. (8, 8, 1)
    feat_drop: float = 0.0
    attn_drop: float = 0.0
    negative_slope: float = 0.2
    activation: Callable = nn.elu
    residual: bool = False
    # Rematerialize each layer in the backward pass: per-edge attention
    # intermediates ((E, H·D) tensors) would otherwise be saved across all
    # layers as residuals.
    remat: bool = True
    # bf16 gathered edge features by default on big graphs (see GATConv);
    # None keeps the input dtype (CPU tests / small graphs)
    edge_dtype: Optional[Any] = None

    @nn.compact
    def __call__(self, graphs, x, *, deterministic: bool = True):
        num_layers = len(self.heads)
        blocks = graphs if isinstance(graphs, (list, tuple)) else [graphs] * num_layers
        if len(blocks) != num_layers:
            raise ValueError(f"expected {num_layers} blocks, got {len(blocks)}")
        conv_cls = nn.remat(GATConv, static_argnums=(3,)) if self.remat else GATConv
        h = x
        for i, g in enumerate(blocks):
            last = i == num_layers - 1
            conv = conv_cls(
                out_feats=self.out_feats if last else self.hidden_feats,
                num_heads=self.heads[i],
                feat_drop=0.0 if i == 0 else self.feat_drop,
                attn_drop=0.0 if i == 0 else self.attn_drop,
                negative_slope=self.negative_slope,
                residual=self.residual,
                activation=None if last else self.activation,
                edge_dtype=self.edge_dtype,
                name=f"gat_{i}",
            )
            feat = (h, h[: g.num_dst_nodes]) if g.is_block else h
            h = conv(g, feat, deterministic)
            # concat heads on hidden layers, average on the output layer
            h = jnp.mean(h, axis=1) if last else h.reshape(h.shape[0], -1)
        return h
