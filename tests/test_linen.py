"""The in-repo module layer (dgl_jax/nn/linen.py): parameter trees, init
distributions, rng streams, mutable collections, remat and submodule
binding."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dgl_jax.nn import linen as nn


class _MLP(nn.Module):
    hidden: int
    out: int

    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Dense(self.hidden)(x))
        x = nn.Dense(self.hidden, use_bias=False)(x)
        return nn.Dense(self.out, name="head")(x)


class _Shared(nn.Module):
    @nn.compact
    def __call__(self, a, b):
        lin = nn.Dense(3, name="lin")
        return lin(a) + lin(b)


class _Counter(nn.Module):
    @nn.compact
    def __call__(self, x):
        n = self.variable("batch_stats", "n", lambda: jnp.zeros((), jnp.int32))
        s = self.variable("batch_stats", "sum", lambda: jnp.zeros(x.shape[-1]))
        if not self.is_initializing():
            n.value = n.value + 1
            s.value = s.value + x.sum(0)
        return x * self.param("scale", nn.initializers.ones, (x.shape[-1],))


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def test_param_tree_names_and_shapes():
    v = _MLP(8, 3).init(jax.random.PRNGKey(0), jnp.ones((5, 4)))
    assert _shapes(v) == {"params": {
        "Dense_0": {"kernel": (4, 8), "bias": (8,)},
        "Dense_1": {"kernel": (8, 8)},
        "head": {"kernel": (8, 3), "bias": (3,)},
    }}


def test_apply_matches_hand_computation():
    m = _MLP(8, 3)
    x = jax.random.normal(jax.random.PRNGKey(1), (5, 4))
    p = m.init(jax.random.PRNGKey(0), x)["params"]
    h = jax.nn.relu(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
    ref = (h @ p["Dense_1"]["kernel"]) @ p["head"]["kernel"] + p["head"]["bias"]
    np.testing.assert_allclose(m.apply({"params": p}, x), ref, rtol=1e-5, atol=1e-6)


def test_submodule_called_twice_shares_params():
    v = _Shared().init(jax.random.PRNGKey(0), jnp.ones((2, 4)), jnp.ones((2, 4)))
    assert _shapes(v) == {"params": {"lin": {"kernel": (4, 3), "bias": (3,)}}}


def test_init_is_deterministic_and_key_dependent():
    x = jnp.ones((2, 16))
    a = _MLP(32, 3).init(jax.random.PRNGKey(0), x)
    b = _MLP(32, 3).init(jax.random.PRNGKey(0), x)
    c = _MLP(32, 3).init(jax.random.PRNGKey(1), x)
    k = lambda v: np.asarray(v["params"]["Dense_0"]["kernel"])  # noqa: E731
    np.testing.assert_array_equal(k(a), k(b))
    assert not np.allclose(k(a), k(c))
    # sibling layers draw distinct keys
    assert not np.allclose(np.asarray(a["params"]["Dense_1"]["kernel"])[:16], k(a))


@pytest.mark.parametrize("init,expected_std", [
    (nn.initializers.lecun_normal(), 1.0 / np.sqrt(256)),
    (nn.initializers.xavier_uniform(), np.sqrt(2.0 / (256 + 512))),
])
def test_dense_init_statistics(init, expected_std):
    m = nn.Dense(512, kernel_init=init)
    w = np.asarray(m.init(jax.random.PRNGKey(0), jnp.ones((1, 256)))["params"]["kernel"])
    assert abs(w.mean()) < 0.05 * expected_std
    assert abs(w.std() / expected_std - 1.0) < 0.05


def test_dropout_modes():
    x = jnp.ones((200, 50))
    drop = nn.Dropout(0.5)
    np.testing.assert_array_equal(drop.apply({}, x, deterministic=True), x)
    np.testing.assert_array_equal(nn.Dropout(0.0).apply({}, x, deterministic=False), x)
    y = np.asarray(drop.apply({}, x, deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(0)}))
    assert set(np.unique(y)) <= {0.0, 2.0}  # inverted scaling 1 / keep
    assert 0.4 < (y == 0).mean() < 0.6
    y2 = np.asarray(drop.apply({}, x, deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(1)}))
    assert not np.array_equal(y, y2)
    with pytest.raises(ValueError, match="rng named 'dropout'"):
        drop.apply({}, x, deterministic=False)
    with pytest.raises(ValueError, match="deterministic"):
        drop.apply({}, x)


def test_batch_stats_mutation():
    m = _Counter()
    x = jnp.arange(6.0).reshape(3, 2)
    v = m.init(jax.random.PRNGKey(0), x)
    assert int(v["batch_stats"]["n"]) == 0
    out, upd = m.apply(v, x, mutable=["batch_stats"])
    assert set(upd) == {"batch_stats"}
    assert int(upd["batch_stats"]["n"]) == 1
    np.testing.assert_allclose(upd["batch_stats"]["sum"], [6.0, 9.0])
    # the caller's variables are not touched
    assert int(v["batch_stats"]["n"]) == 0
    with pytest.raises(ValueError, match="not mutable"):
        m.apply(v, x)


def test_missing_param_raises():
    with pytest.raises(ValueError, match="missing"):
        nn.Dense(3).apply({"params": {}}, jnp.ones((1, 2)))


def test_duplicate_submodule_name_raises():
    class Dup(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(2, name="a")(x) + nn.Dense(2, name="a")(x)

    with pytest.raises(ValueError, match="used twice"):
        Dup().init(jax.random.PRNGKey(0), jnp.ones((1, 2)))


def test_unbound_call_raises():
    with pytest.raises(ValueError, match="unbound"):
        nn.Dense(2)(jnp.ones((1, 2)))


def test_module_passed_as_field_is_adopted():
    class Holder(nn.Module):
        inner: nn.Module

        @nn.compact
        def __call__(self, x):
            return self.inner(x) + self.inner(x)

    m = Holder(nn.Dense(3, name="proj"))
    v = m.init(jax.random.PRNGKey(0), jnp.ones((2, 4)))
    assert _shapes(v) == {"params": {"proj": {"kernel": (4, 3), "bias": (3,)}}}
    # the same holder applies again (adoption is per run)
    out = m.apply(v, jnp.ones((2, 4)))
    np.testing.assert_allclose(out, 2 * (jnp.ones((2, 4)) @ v["params"]["proj"]["kernel"]
                                         + v["params"]["proj"]["bias"]), rtol=1e-6)


def test_embed_lookup_and_init():
    e = nn.Embed(1000, 64)
    v = e.init(jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))
    table = np.asarray(v["params"]["embedding"])
    assert table.shape == (1000, 64)
    # variance_scaling(1, fan_in, normal, out_axis=0): std 1/sqrt(features)
    assert abs(table.std() * np.sqrt(64) - 1.0) < 0.05
    idx = jnp.asarray([3, 0, 999])
    np.testing.assert_array_equal(e.apply(v, idx), table[[3, 0, 999]])
    with pytest.raises(ValueError, match="integer"):
        e.apply(v, jnp.ones((2,)))


def test_remat_matches_plain_value_and_grad():
    Plain = _MLP
    Remat = nn.remat(_MLP)
    x = jax.random.normal(jax.random.PRNGKey(3), (7, 4))
    p = Plain(16, 2).init(jax.random.PRNGKey(0), x)
    assert _shapes(Remat(16, 2).init(jax.random.PRNGKey(0), x)) == _shapes(p)

    def loss(m, p):
        return jnp.sum(m.apply(p, x) ** 2)

    lp, gp = jax.value_and_grad(lambda p: loss(Plain(16, 2), p))(p)
    lr, gr = jax.value_and_grad(lambda p: loss(Remat(16, 2), p))(p)
    np.testing.assert_allclose(lr, lp, rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(gr), jax.tree_util.tree_leaves(gp)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_remat_static_arg_and_rng_inside():
    class Drop(nn.Module):
        @nn.compact
        def __call__(self, x, deterministic):
            return nn.Dropout(0.5)(nn.Dense(4)(x), deterministic=deterministic)

    R = nn.remat(Drop, static_argnums=(2,))
    x = jnp.ones((3, 4))
    p = R().init(jax.random.PRNGKey(0), x, True)
    rngs = {"dropout": jax.random.PRNGKey(5)}
    a = R().apply(p, x, False, rngs=rngs)
    b = Drop().apply(p, x, False, rngs=rngs)
    np.testing.assert_allclose(a, b)  # same rng stream inside the checkpoint
    g = jax.grad(lambda p: jnp.sum(R().apply(p, x, False, rngs=rngs)))(p)
    assert all(np.all(np.isfinite(l)) for l in jax.tree_util.tree_leaves(g))


def test_jit_of_init_and_apply():
    m = _MLP(8, 3)
    x = jnp.ones((2, 4))
    v = jax.jit(m.init)(jax.random.PRNGKey(0), x)
    out = jax.jit(m.apply)(v, x)
    np.testing.assert_allclose(out, m.apply(v, x), rtol=1e-6)
