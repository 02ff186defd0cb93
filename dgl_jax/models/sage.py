"""GraphSAGE networks (full-graph and sampled-block variants).

Architecture parity targets:
* 2-layer citation/reddit net — ``main_dgl_citation_sage.py:88-111``
  (hidden→classes, relu on hidden, dropout on last layer input).
* N-layer OGB net with BatchNorm — ``main_dgl_arxiv_sage.py:68-99``
  (BN+relu+dropout between layers, log_softmax output by the driver).
* Block-wise sampled net — ``ns-sage-dgl.py:21-48`` (each layer consumes a
  bipartite block; dst features are the leading slice of src features).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax.numpy as jnp
from ..nn import linen as nn

from ..graph.graph import Graph
from ..nn import SAGEConv, MaskedBatchNorm


class GraphSAGE(nn.Module):
    """Multi-layer GraphSAGE over one graph or a list of sampled blocks.

    With ``batch_norm=True`` matches the arxiv/products reference net
    (BN between layers); otherwise the 2-layer citation net when
    ``num_layers=2``.
    """

    hidden_feats: int
    out_feats: int
    num_layers: int = 2
    aggr: str = "mean"
    dropout: float = 0.5
    batch_norm: bool = False
    msg_dtype: Optional[Any] = None  # see SAGEConv.msg_dtype

    @nn.compact
    def __call__(
        self,
        graphs,  # Graph | Sequence[Graph] (one block per layer)
        x: jnp.ndarray,
        *,
        x_agg: jnp.ndarray = None,
        deterministic: bool = True,
    ):
        """``x_agg`` (optional): precomputed ``gspmm(g, copy_u, aggr, x)`` of
        the *input* features. In full-graph training the layer-1 neighbor
        aggregation input never changes, so hoisting it out of the step
        removes the entire layer-1 message passing from the hot loop —
        mathematically exact because aggregation commutes with the linear
        projection (same trick the reference ships as ``use_pp``,
        ``dgl_cluster_sampler.py:71-82``). Only valid when layer-1 input has
        no dropout applied before aggregation (our citation config applies
        feat_drop only on the last layer, matching
        ``main_dgl_citation_sage.py:100-101``).
        """
        blocks = graphs if isinstance(graphs, (list, tuple)) else [graphs] * self.num_layers
        if len(blocks) != self.num_layers:
            raise ValueError(f"expected {self.num_layers} blocks, got {len(blocks)}")
        h = x
        for i, g in enumerate(blocks):
            agg_kw = {"x_agg": x_agg} if (i == 0 and x_agg is not None) else {}
            last = i == self.num_layers - 1
            out_dim = self.out_feats if last else self.hidden_feats
            # bipartite blocks: dst nodes are the first num_dst rows of src
            feat = (h, h[: g.num_dst_nodes]) if g.is_block else h
            if self.batch_norm:
                # reference arxiv net: conv -> BN -> relu -> dropout
                h = SAGEConv(out_dim, aggr=self.aggr, msg_dtype=self.msg_dtype,
                             name=f"conv_{i}")(
                    g, feat, deterministic=deterministic, **agg_kw
                )
                if not last:
                    h = MaskedBatchNorm(name=f"bn_{i}")(
                        h, use_running_average=deterministic
                    )
                    h = nn.relu(h)
                    h = nn.Dropout(self.dropout, deterministic=deterministic)(h)
            else:
                # reference citation net: relu inside hidden convs, feat-drop
                # on the last conv's input
                h = SAGEConv(
                    out_dim,
                    aggr=self.aggr,
                    feat_drop=self.dropout if last else 0.0,
                    activation=None if last else nn.relu,
                    msg_dtype=self.msg_dtype,
                    name=f"conv_{i}",
                )(g, feat, deterministic=deterministic, **agg_kw)
        return h
