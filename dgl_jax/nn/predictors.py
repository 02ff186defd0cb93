"""Edge scorers for link prediction.

Reference semantics: dot-product scorer via ``apply_edges(fn.u_dot_v)``
(``cluster_gcn_dgl.py:91-102``) and the MLP-on-hadamard ``LinkPredictor``
(``cluster_gcn_dgl.py:64-88``).
"""

from __future__ import annotations

import jax.numpy as jnp
from . import linen as nn

from ..graph.graph import Graph
from ..ops import u_dot_v, u_mul_v

__all__ = ["DotPredictor", "MLPPredictor", "PairMLPPredictor"]


class DotPredictor(nn.Module):
    """score[e] = h[src] · h[dst] (squeezed)."""

    @nn.compact
    def __call__(self, g: Graph, h: jnp.ndarray):
        return u_dot_v(g, h, h)[:, 0]


class MLPPredictor(nn.Module):
    """MLP over the hadamard product of endpoint embeddings
    (``cluster_gcn_dgl.py:64-88``: Linear→ReLU→dropout ×(L-1) → Linear→1)."""

    hidden: int
    num_layers: int = 3
    dropout: float = 0.0

    @nn.compact
    def __call__(self, g: Graph, h: jnp.ndarray, *, deterministic: bool = True):
        x = u_mul_v(g, h, h)
        for i in range(self.num_layers - 1):
            x = nn.Dense(self.hidden, name=f"lin_{i}")(x)
            x = nn.relu(x)
            x = nn.Dropout(self.dropout, deterministic=deterministic)(x)
        x = nn.Dense(1, name="lin_out")(x)
        return x[:, 0]


class PairMLPPredictor(nn.Module):
    """Same MLP head applied to explicit (x_i, x_j) pairs (the reference's
    eval path feeds gathered pairs, ``cluster_gcn_dgl.py:176-189``)."""

    hidden: int
    num_layers: int = 3
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x_i, x_j, *, deterministic: bool = True):
        x = x_i * x_j
        for i in range(self.num_layers - 1):
            x = nn.Dense(self.hidden, name=f"lin_{i}")(x)
            x = nn.relu(x)
            x = nn.Dropout(self.dropout, deterministic=deterministic)(x)
        x = nn.Dense(1, name="lin_out")(x)
        return x[:, 0]
