"""GCMC + heterograph tests: layer math vs oracle, end-to-end learning."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from dgl_jax.nn import linen as nn

from dgl_jax import from_edges
from dgl_jax.graph.hetero import HeteroGraph
from dgl_jax.nn import (
    BiDecoder,
    DenseBiDecoder,
    GCMCGraphConv,
    HeteroGraphConv,
    SAGEConv,
)
from dgl_jax.data.movielens import load_movielens


def test_gcmc_graph_conv_math(rng):
    n_u, n_m, e = 8, 6, 20
    src = rng.integers(0, n_u, e)
    dst = rng.integers(0, n_m, e)
    g = from_edges(src, dst, n_u, n_m)
    x = rng.standard_normal((n_u, 5)).astype(np.float32)
    cj = rng.random((n_u, 1)).astype(np.float32)
    ci = rng.random((n_m, 1)).astype(np.float32)
    conv = GCMCGraphConv(4)
    params = conv.init(jax.random.PRNGKey(0), g, (jnp.asarray(x), None),
                       jnp.asarray(cj), jnp.asarray(ci))
    out = np.asarray(conv.apply(params, g, (jnp.asarray(x), None),
                                jnp.asarray(cj), jnp.asarray(ci)))
    W = np.asarray(params["params"]["weight"])
    feat = (x @ W) * cj
    ref = np.zeros((n_m, 4))
    for u, v in zip(src, dst):
        ref[v] += feat[u]
    ref *= ci
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_bidecoder_math(rng):
    n_u, n_m, e = 6, 5, 12
    src = rng.integers(0, n_u, e)
    dst = rng.integers(0, n_m, e)
    dec_g = from_edges(src, dst, n_u, n_m)
    u = rng.standard_normal((n_u, 4)).astype(np.float32)
    v = rng.standard_normal((n_m, 4)).astype(np.float32)
    dec = BiDecoder(num_classes=3, num_basis=2)
    params = dec.init(jax.random.PRNGKey(0), dec_g, jnp.asarray(u), jnp.asarray(v))
    out = np.asarray(dec.apply(params, dec_g, jnp.asarray(u), jnp.asarray(v)))
    Ps = np.asarray(params["params"]["Ps"])
    Wc = np.asarray(params["params"]["combine_basis"]["kernel"])
    eid = np.asarray(dec_g.eid)[: dec_g.num_edges]
    s_can = np.asarray(dec_g.src)[: dec_g.num_edges]
    d_can = np.asarray(dec_g.dst)[: dec_g.num_edges]
    basis = np.stack(
        [np.sum((u[s_can] @ Ps[i]) * v[d_can], axis=1) for i in range(2)], axis=1
    )
    ref = basis @ Wc
    np.testing.assert_allclose(out[: dec_g.num_edges], ref, rtol=1e-4, atol=1e-4)


def test_dense_bidecoder(rng):
    u = jnp.asarray(rng.standard_normal((7, 4)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((7, 4)).astype(np.float32))
    dec = DenseBiDecoder(num_classes=5, num_basis=2)
    params = dec.init(jax.random.PRNGKey(0), u, v)
    out = dec.apply(params, u, v)
    assert out.shape == (7, 5)
    assert np.all(np.isfinite(np.asarray(out)))


def test_hetero_graph_conv(rng):
    n_a, n_b = 6, 4
    g_ab = from_edges(rng.integers(0, n_a, 10), rng.integers(0, n_b, 10), n_a, n_b)
    g_bb = from_edges(rng.integers(0, n_b, 8), rng.integers(0, n_b, 8), n_b, n_b)
    hg = HeteroGraph(
        {("a", "r1", "b"): g_ab, ("b", "r2", "b"): g_bb},
        {"a": n_a, "b": n_b},
    ).validate()
    conv = HeteroGraphConv(
        convs={"r1": SAGEConv(5, name="c1"), "r2": SAGEConv(5, name="c2")},
        agg="sum",
    )
    feats = {
        "a": jnp.asarray(rng.standard_normal((n_a, 3)).astype(np.float32)),
        "b": jnp.asarray(rng.standard_normal((n_b, 3)).astype(np.float32)),
    }
    params = conv.init(jax.random.PRNGKey(0), hg, feats)
    out = conv.apply(params, hg, feats)
    assert set(out.keys()) == {"b"}
    assert out["b"].shape == (n_b, 5)


def test_movielens_pipeline():
    data = load_movielens("ml-100k", seed=0)
    assert data.num_users == 943 and data.num_movies == 1682
    assert data.rating_vals == [1, 2, 3, 4, 5]
    enc, dec, y = data.train
    # every rating etype present forward + reverse
    assert len(enc.relations) == 10
    enc.validate()
    # decoder labels are class indices
    assert y.max() < 5 and y.min() >= 0
    # norms shaped per node type
    ci_u, cj_u = data.norms["user"]
    assert ci_u.shape == (943, 1)


def test_gcmc_layer_share_param(rng):
    """share_user_item_param must build one W_r per rating (regression:
    duplicate param creation crashed the module layer)."""
    from dgl_jax.nn import GCMCLayer

    n_u, n_m = 6, 5
    rels = {}
    for r in ("1", "2"):
        s = rng.integers(0, n_u, 8)
        d = rng.integers(0, n_m, 8)
        rels[("user", r, "movie")] = from_edges(s, d, n_u, n_m)
        rels[("movie", f"rev-{r}", "user")] = from_edges(d, s, n_m, n_u)
    hg = HeteroGraph(rels, {"user": n_u, "movie": n_m})
    u = jnp.asarray(rng.standard_normal((n_u, 4)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((n_m, 4)).astype(np.float32))
    norms = {
        "user": (jnp.ones((n_u, 1)), jnp.ones((n_u, 1))),
        "movie": (jnp.ones((n_m, 1)), jnp.ones((n_m, 1))),
    }
    layer = GCMCLayer(rating_vals=["1", "2"], msg_units=4, out_units=3,
                      share_user_item_param=True)
    params = layer.init(jax.random.PRNGKey(0), hg, u, v, norms)
    ou, oi = layer.apply(params, hg, u, v, norms)
    assert ou.shape == (n_u, 3) and oi.shape == (n_m, 3)
    assert "W_r_1" in params["params"] and "W_r_2" in params["params"]
    # unequal dims -> clean error
    with pytest.raises(ValueError, match="equal user/movie"):
        layer.init(jax.random.PRNGKey(0), hg, u,
                   jnp.zeros((n_m, 7)), norms)
