"""Full-graph GraphSAGE training over the edge-partitioned halo path.

The reference can only full-graph-train what fits one GPU — ogbn-products
SAGE is an OOM row for PyG (``/root/reference/README.md:46``) and reddit GAT
for PyG (``:43``). Here the graph, activations, AND optimizer state scale
across devices: nodes live in contiguous per-device ranges, every SpMM is
:func:`halo_spmm_boundary` (all_to_all of exactly the boundary rows, local
aggregation overlapped with the exchange), and parameters stay replicated
with gradient all-reduce inserted by GSPMD.

The model math matches ``nn.conv.SAGEConv`` (reference
``main_dgl_citation_sage.py:44-86``): ``fc_self(x) + fc_neigh(mean_agg(x))``
per layer, ReLU between layers, masked CE on the outputs.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp
import optax

from .halo import BoundarySharded, halo_gat_boundary, halo_spmm_boundary

__all__ = [
    "halo_sage_init",
    "halo_sage_apply",
    "halo_gat_init",
    "halo_gat_apply",
    "make_halo_train_step",
    "exchange_stats",
]


def halo_sage_init(key, in_feats: int, hidden_feats: int, out_feats: int,
                   num_layers: int = 2):
    """Xavier-initialized parameter pytree for the sharded SAGE stack."""
    dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [out_feats]
    params = []
    for i in range(num_layers):
        key, k1, k2 = jax.random.split(key, 3)
        fan_in, fan_out = dims[i], dims[i + 1]
        s = float(np.sqrt(6.0 / (fan_in + fan_out)))
        params.append({
            "w_self": jax.random.uniform(k1, (fan_in, fan_out), jnp.float32, -s, s),
            "w_neigh": jax.random.uniform(k2, (fan_in, fan_out), jnp.float32, -s, s),
            "bias": jnp.zeros((fan_out,), jnp.float32),
        })
    return params


def halo_sage_apply(params, bs: BoundarySharded, x, mesh, axis: str = "graph",
                    aggr: str = "mean", dropout: float = 0.0, key=None):
    """Forward over row-sharded ``x`` (n_pad, D): logits (n_pad, C),
    row-sharded. The per-layer dense projections run on the device's own
    rows only (GSPMD keeps them sharded); each aggregation is one
    boundary-halo exchange. Dropout (reference applies it to every layer
    input) is active only when ``key`` is given."""
    h = x
    for i, layer in enumerate(params):
        if dropout > 0.0 and key is not None:
            key, sub = jax.random.split(key)
            keep = 1.0 - dropout
            h = h * jax.random.bernoulli(sub, keep, h.shape) / keep
        agg = halo_spmm_boundary(bs, h, mesh, axis=axis, reduce=aggr)
        h = h @ layer["w_self"] + agg @ layer["w_neigh"] + layer["bias"]
        if i < len(params) - 1:
            h = jax.nn.relu(h)
    return h


def halo_gat_init(key, in_feats: int, hidden_feats: int, out_feats: int,
                  heads: Sequence[int] = (4, 4, 4)):
    """Xavier-initialized parameters for the sharded GAT stack (mirrors
    ``nn.conv.GATConv``: fused fc + per-head attention vectors)."""
    dims_in = [in_feats] + [hidden_feats * h for h in heads[:-1]]
    dims_out = [hidden_feats] * (len(heads) - 1) + [out_feats]
    params = []
    for i, h in enumerate(heads):
        key, k1, k2, k3 = jax.random.split(key, 4)
        fan_in, d = dims_in[i], dims_out[i]
        s = float(np.sqrt(6.0 / (fan_in + h * d)))
        sa = float(np.sqrt(6.0 / (d + 1)))
        params.append({
            "w": jax.random.uniform(k1, (fan_in, h * d), jnp.float32, -s, s),
            "attn_l": jax.random.uniform(k2, (1, h, d), jnp.float32, -sa, sa),
            "attn_r": jax.random.uniform(k3, (1, h, d), jnp.float32, -sa, sa),
        })
    return params


def halo_gat_apply(params, bs: BoundarySharded, x, mesh, axis: str = "graph",
                   heads: Sequence[int] = (4, 4, 4),
                   negative_slope: float = 0.2):
    """Sharded multi-head GAT forward (reference N5–N7 math): per layer one
    boundary exchange of ``[z | a_src]`` rows through
    :func:`halo_gat_boundary`; heads concat on hidden layers, mean on the
    output layer. Covers the workload the reference's single-GPU PyG OOMs
    on (reddit GAT, ``README.md:43``)."""
    h = x
    for i, layer in enumerate(params):
        nh = heads[i]
        z = (h @ layer["w"]).reshape(h.shape[0], nh, -1)
        a_src = jnp.sum(z * layer["attn_r"], axis=-1)
        a_dst = jnp.sum(z * layer["attn_l"], axis=-1)
        agg = halo_gat_boundary(bs, z, a_src, a_dst, mesh, axis=axis,
                                negative_slope=negative_slope)
        if i < len(params) - 1:
            h = jax.nn.elu(agg.reshape(agg.shape[0], -1))
        else:
            h = jnp.mean(agg, axis=1)
    return h


def make_halo_train_step(mesh, tx, axis: str = "graph",
                         aggr: str = "mean", dropout: float = 0.0):
    """jitted (params, opt_state, key, bs, x, y, mask) -> (params,
    opt_state, loss).

    ``x``/``y``/``mask`` are row-sharded (n_pad, ·); params/opt_state
    replicated. ``bs`` is a jit ARGUMENT (closed-over arrays would be baked
    into the HLO as constants — fatal at products scale). The masked-CE
    reduction over sharded rows and the gradient all-reduce are inserted by
    GSPMD.
    """

    def loss_fn(params, key, bs, x, y, mask):
        logits = halo_sage_apply(params, bs, x, mesh, axis=axis, aggr=aggr,
                                 dropout=dropout, key=key)
        logp = jax.nn.log_softmax(logits)
        ce = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        m = mask.astype(ce.dtype)
        return jnp.sum(ce * m) / jnp.maximum(jnp.sum(m), 1.0)

    @jax.jit
    def train_step(params, opt_state, key, bs, x, y, mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, key, bs, x, y, mask)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return train_step


def exchange_stats(bs: BoundarySharded, d: int, itemsize: int = 4) -> dict:
    """Per-layer communication accounting: boundary all_to_all volume vs
    what the all-gather halo would move."""
    k = bs.num_shards
    boundary = k * bs.rows_per_pair * d * itemsize  # per device per layer
    allgather = (k - 1) * bs.nodes_per_shard * d * itemsize
    return {
        "num_shards": k,
        "rows_per_pair": bs.rows_per_pair,
        "boundary_bytes_per_device": boundary,
        "allgather_bytes_per_device": allgather,
        "volume_ratio": boundary / max(allgather, 1),
    }


def halo_rgcn_init(key, in_feats: int, hidden_feats: int, out_feats: int,
                   num_relations: int, num_layers: int = 3):
    """Kaiming-initialized parameters for the sharded RGCN stack (mirrors
    ``nn.conv.RelGraphConv``: per-relation projections + dense skip)."""
    dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [out_feats]
    params = []
    for i in range(num_layers):
        key, k1, k2 = jax.random.split(key, 3)
        fan_in, fan_out = dims[i], dims[i + 1]
        s = float(np.sqrt(6.0 / fan_in))  # kaiming_uniform(a=sqrt(5)) scale
        params.append({
            "w_rel": jax.random.uniform(
                k1, (num_relations, fan_in, fan_out), jnp.float32, -s, s),
            "w_skip": jax.random.uniform(
                k2, (fan_in, fan_out), jnp.float32, -s, s),
            "bias": jnp.zeros((fan_out,), jnp.float32),
        })
    return params


def halo_rgcn_apply(params, bs: BoundarySharded, x, w_local, w_halo,
                    num_relations: int, mesh, axis: str = "graph"):
    """Sharded RGCN forward (reference N8 semantics,
    ``main_dgl_proteins_rgcn_for.py:46-60``): per layer, project into the
    flat (R·D) per-relation stack (sharded batched matmul), one boundary
    exchange + relation-contracted aggregation, plus the dense skip term.
    ``w_local``/``w_halo`` are the plan-layout relation weights from
    :func:`dgl_jax.parallel.plan_layout_edata_boundary` (dataset constants
    for proteins)."""
    from .halo import halo_rgcn_boundary

    h = x
    for i, layer in enumerate(params):
        n, _ = h.shape
        r, _, d = layer["w_rel"].shape
        y = jnp.einsum("nd,rdo->nro", h, layer["w_rel"]).reshape(n, r * d)
        agg = halo_rgcn_boundary(bs, y, w_local, w_halo, num_relations,
                                 mesh, axis=axis, reduce="mean")
        h = agg + h @ layer["w_skip"] + layer["bias"]
        if i < len(params) - 1:
            h = jax.nn.relu(h)
    return h


def make_halo_gat_train_step(mesh, tx, heads, axis: str = "graph",
                             negative_slope: float = 0.2):
    """jitted sharded-GAT train step (masked CE; conventions as
    :func:`make_halo_train_step`)."""

    def loss_fn(params, bs, x, y, mask):
        logits = halo_gat_apply(params, bs, x, mesh, axis=axis, heads=heads,
                                negative_slope=negative_slope)
        logp = jax.nn.log_softmax(logits)
        ce = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        m = mask.astype(ce.dtype)
        return jnp.sum(ce * m) / jnp.maximum(jnp.sum(m), 1.0)

    @jax.jit
    def train_step(params, opt_state, bs, x, y, mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, bs, x, y, mask)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return train_step


def make_halo_rgcn_train_step(mesh, tx, num_relations: int,
                              axis: str = "graph"):
    """jitted sharded-RGCN train step — multilabel BCE-with-logits over
    masked rows (proteins N8 semantics,
    ``main_dgl_proteins_rgcn_for.py:101``)."""

    def loss_fn(params, bs, x, wl, wh, y, mask):
        logits = halo_rgcn_apply(params, bs, x, wl, wh, num_relations, mesh,
                                 axis=axis)
        ls = jax.nn.log_sigmoid
        per = -(y * ls(logits) + (1.0 - y) * ls(-logits))  # (n, T)
        m = mask.astype(per.dtype)
        return jnp.sum(per.mean(axis=-1) * m) / jnp.maximum(jnp.sum(m), 1.0)

    @jax.jit
    def train_step(params, opt_state, bs, x, wl, wh, y, mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, bs, x, wl, wh, y, mask)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return train_step
