"""GCMC (Graph Convolutional Matrix Completion) layers.

Reimplementation of the reference's GCMC model family
(``gcmc_dgl/model.py``): degree-normalized per-rating graph convolution,
the heterograph encoder layer, and the bilinear basis decoders. The
``DenseBiDecoder`` here also fixes the reference's latent bug
(``model.py:395`` references ``self.P`` which never exists; the parameters
are ``self.Ps`` — SURVEY §2.1 P2).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import jax.numpy as jnp
from . import linen as nn

from ..graph.graph import Graph
from ..graph.hetero import HeteroGraph
from ..ops import gspmm, u_dot_v
from .init import xavier_uniform

__all__ = ["GCMCGraphConv", "GCMCLayer", "BiDecoder", "DenseBiDecoder"]


class GCMCGraphConv(nn.Module):
    """Per-rating graph conv: ``ci * sum_by_dst(cj * (x W))``.

    Math of ``gcmc_dgl/model.py:10-96``: the symmetric norm constants
    ``cj`` (per src) / ``ci`` (per dst) are precomputed from hetero degrees
    by the data pipeline and passed in; dropout is applied to ``cj``
    (matching the reference's ``feat * self.dropout(cj)``).
    """

    out_feats: int
    use_weight: bool = True
    dropout_rate: float = 0.0

    @nn.compact
    def __call__(
        self,
        g: Graph,
        x: Tuple[jnp.ndarray, jnp.ndarray],
        cj: jnp.ndarray,  # (N_src, 1)
        ci: jnp.ndarray,  # (N_dst, 1)
        weight: Optional[jnp.ndarray] = None,
        *,
        deterministic: bool = True,
    ):
        feat = x[0] if isinstance(x, (tuple, list)) else x
        if self.use_weight:
            if weight is not None:
                raise ValueError("external weight given but use_weight=True")
            weight = self.param(
                "weight", xavier_uniform(), (feat.shape[-1], self.out_feats)
            )
        if weight is not None:
            feat = feat @ weight
        if self.dropout_rate > 0.0:
            cj = nn.Dropout(self.dropout_rate, deterministic=deterministic)(cj)
        feat = feat * cj
        rst = gspmm(g, "copy_u", "sum", x=feat)
        return rst * ci


class GCMCLayer(nn.Module):
    """Hetero encoder layer (``gcmc_dgl/model.py:99-271``).

    One GCMCGraphConv per rating edge type (forward + reverse), combined
    with stack (default) or sum, then activation → dropout → per-node-type
    dense projection.

    Call with the rating heterograph, user/movie features, and the norm
    dict {node_type: (ci, cj)} from the data pipeline.
    """

    rating_vals: Sequence[str]
    msg_units: int
    out_units: int
    dropout_rate: float = 0.0
    agg: str = "stack"
    agg_act: Optional[Callable] = None
    out_act: Optional[Callable] = None
    share_user_item_param: bool = False

    @nn.compact
    def __call__(
        self,
        hg: HeteroGraph,
        ufeat: jnp.ndarray,
        ifeat: jnp.ndarray,
        norms: Dict[str, Tuple[jnp.ndarray, jnp.ndarray]],  # ntype -> (ci, cj)
        *,
        deterministic: bool = True,
    ):
        msg_units = self.msg_units
        if self.agg == "stack":
            if msg_units % len(self.rating_vals) != 0:
                raise ValueError("msg_units must divide by number of ratings for stack agg")
            msg_units = msg_units // len(self.rating_vals)

        feats = {"user": ufeat, "movie": ifeat}
        ci = {nt: norms[nt][0] for nt in norms}
        cj = {nt: norms[nt][1] for nt in norms}

        outs: Dict[str, list] = {"user": [], "movie": []}
        for rating in self.rating_vals:
            w_shared = None
            if self.share_user_item_param:
                if ufeat.shape[-1] != ifeat.shape[-1]:
                    raise ValueError(
                        "share_user_item_param requires equal user/movie "
                        f"feature dims, got {ufeat.shape[-1]} vs {ifeat.shape[-1]}"
                    )
                # one shared W_r per rating, created once and used by both
                # the forward and the reverse relation
                w_shared = self.param(
                    f"W_r_{rating}", xavier_uniform(),
                    (ufeat.shape[-1], msg_units),
                )
            for rel, rev in ((str(rating), False), (f"rev-{rating}", True)):
                stype, dtype = ("movie", "user") if rev else ("user", "movie")
                etype = (stype, rel, dtype)
                if self.share_user_item_param:
                    w = w_shared
                    conv = GCMCGraphConv(
                        msg_units,
                        use_weight=False,
                        dropout_rate=self.dropout_rate,
                        name=f"conv_{rel}",
                    )
                    out = conv(
                        hg[etype],
                        (feats[stype], feats[dtype]),
                        cj[stype],
                        ci[dtype],
                        weight=w,
                        deterministic=deterministic,
                    )
                else:
                    conv = GCMCGraphConv(
                        msg_units,
                        use_weight=True,
                        dropout_rate=self.dropout_rate,
                        name=f"conv_{rel}",
                    )
                    out = conv(
                        hg[etype],
                        (feats[stype], feats[dtype]),
                        cj[stype],
                        ci[dtype],
                        deterministic=deterministic,
                    )
                outs[dtype].append(out)

        def combine(lst):
            if self.agg == "stack":
                return jnp.stack(lst, axis=1).reshape(lst[0].shape[0], -1)
            if self.agg == "sum":
                return sum(lst)
            raise ValueError(f"unknown agg {self.agg!r}")

        act = self.agg_act or (lambda a: a)
        oact = self.out_act or (lambda a: a)
        drop = nn.Dropout(self.dropout_rate, deterministic=deterministic)

        ufc = nn.Dense(self.out_units, name="ufc")
        ifc = ufc if self.share_user_item_param else nn.Dense(self.out_units, name="ifc")
        u = ufc(drop(act(combine(outs["user"]))))
        i = ifc(drop(act(combine(outs["movie"]))))
        return oact(u), oact(i)


class BiDecoder(nn.Module):
    """Bilinear basis decoder (``gcmc_dgl/model.py:273-346``):
    ``score[e, r] = sum_s a_{rs} * (u_i P_s) · v_j`` on a user→movie pair
    graph."""

    num_classes: int
    num_basis: int = 2
    dropout_rate: float = 0.0

    @nn.compact
    def __call__(
        self,
        dec_graph: Graph,
        ufeat: jnp.ndarray,
        ifeat: jnp.ndarray,
        *,
        deterministic: bool = True,
    ):
        drop = nn.Dropout(self.dropout_rate, deterministic=deterministic)
        ufeat = drop(ufeat)
        ifeat = drop(ifeat)
        d = ufeat.shape[-1]
        Ps = self.param("Ps", xavier_uniform(), (self.num_basis, d, d))
        basis_out = [
            u_dot_v(dec_graph, ufeat @ Ps[i], ifeat) for i in range(self.num_basis)
        ]
        out = jnp.concatenate(basis_out, axis=1)  # (E, num_basis)
        return nn.Dense(self.num_classes, use_bias=False, name="combine_basis")(out)


class DenseBiDecoder(nn.Module):
    """Dense pairwise variant: score aligned pairs (ufeat[i], ifeat[i]).

    The reference class is broken/unused (``model.py:395`` uses ``self.P``
    which doesn't exist); this is the corrected math:
    ``out[a, s] = u_a P_s · v_a`` combined across bases.
    """

    num_classes: int
    num_basis: int = 2
    dropout_rate: float = 0.0

    @nn.compact
    def __call__(self, ufeat, ifeat, *, deterministic: bool = True):
        drop = nn.Dropout(self.dropout_rate, deterministic=deterministic)
        ufeat = drop(ufeat)
        ifeat = drop(ifeat)
        d = ufeat.shape[-1]
        Ps = self.param("Ps", xavier_uniform(), (self.num_basis, d, d))
        out = jnp.einsum("ai,sij,aj->as", ufeat, Ps, ifeat)
        return nn.Dense(self.num_classes, use_bias=False, name="combine_basis")(out)
