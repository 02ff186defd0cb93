"""GCMC end-to-end net: hetero encoder + bilinear decoder.

Parity: ``gcmc_dgl/train.py:17-41`` (``Net`` = GCMCLayer encoder +
BiDecoder over the user–movie pair graph).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import jax.numpy as jnp
from ..nn import linen as nn

from ..graph.graph import Graph
from ..graph.hetero import HeteroGraph
from ..nn import BiDecoder, GCMCLayer


class GCMCNet(nn.Module):
    rating_vals: Sequence[str]
    msg_units: int = 500
    out_units: int = 75
    dropout_rate: float = 0.7
    agg: str = "stack"
    agg_act: Optional[Callable] = nn.leaky_relu
    num_basis: int = 2
    share_user_item_param: bool = False

    @nn.compact
    def __call__(
        self,
        enc_graph: HeteroGraph,
        dec_graph: Graph,
        ufeat: jnp.ndarray,
        ifeat: jnp.ndarray,
        norms: Dict[str, Tuple[jnp.ndarray, jnp.ndarray]],
        *,
        deterministic: bool = True,
    ):
        u, i = GCMCLayer(
            rating_vals=self.rating_vals,
            msg_units=self.msg_units,
            out_units=self.out_units,
            dropout_rate=self.dropout_rate,
            agg=self.agg,
            agg_act=self.agg_act,
            share_user_item_param=self.share_user_item_param,
            name="encoder",
        )(enc_graph, ufeat, ifeat, norms, deterministic=deterministic)
        scores = BiDecoder(
            num_classes=len(self.rating_vals),
            num_basis=self.num_basis,
            name="decoder",
        )(dec_graph, u, i, deterministic=deterministic)
        return scores
