"""Molecular feature encoders (OGB-compatible) + pooling/prediction heads.

The reference imports ``AtomEncoder``/``BondEncoder`` from the OGB package
(``main_dgl_molhiv_gcn.py:14``); OGB is not a dependency here, so these are
independent implementations of the same scheme: each categorical input
column gets its own embedding table and the embeddings are summed. The
default vocabulary sizes are the public OGB mol feature dimensions.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
from . import linen as nn

__all__ = ["AtomEncoder", "BondEncoder", "CategoricalEncoder"]

# Public OGB molecule feature vocabularies (ogb.utils.features):
# atom: [atomic_num, chirality, degree, formal_charge, num_h, num_rad_e,
#        hybridization, is_aromatic, is_in_ring]
ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
# bond: [bond_type, bond_stereo, is_conjugated]
BOND_FEATURE_DIMS = (5, 6, 2)


class CategoricalEncoder(nn.Module):
    """Sum of per-column embeddings for integer categorical features."""

    emb_dim: int
    feature_dims: Sequence[int]

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:  # x: (N, F) int
        out = 0.0
        for i, vocab in enumerate(self.feature_dims):
            emb = nn.Embed(
                vocab,
                self.emb_dim,
                embedding_init=nn.initializers.xavier_uniform(),
                name=f"emb_{i}",
            )
            idx = jnp.clip(x[:, i], 0, vocab - 1)
            out = out + emb(idx)
        return out


class AtomEncoder(CategoricalEncoder):
    feature_dims: Sequence[int] = ATOM_FEATURE_DIMS


class BondEncoder(CategoricalEncoder):
    feature_dims: Sequence[int] = BOND_FEATURE_DIMS
