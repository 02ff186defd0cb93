"""Graph disk-cache round trip (dgl_jax/graph/cache.py): cached prep must
reproduce the exact canonical arrays — the suite's big rows (products/
cluster) depend on it to amortize ~5 min of host prep per subprocess."""

import numpy as np
import pytest

import dgl_jax
from dgl_jax.graph.cache import cached_graph, load_graph, save_graph


@pytest.fixture
def g_np(rng):
    n, e = 300, 4000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    return dgl_jax.from_edges(src, dst, n, device=False)


def _assert_graph_equal(a, b):
    for name in ("src", "dst", "indptr", "eid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, name)), np.asarray(getattr(b, name)), err_msg=name)
    assert (a.num_src_nodes, a.num_dst_nodes, a.num_edges) == (
        b.num_src_nodes, b.num_dst_nodes, b.num_edges)
    for name in ("segblocks",):
        ta, tb = getattr(a, name), getattr(b, name)
        assert (ta is None) == (tb is None)
        if ta is not None:
            for x, y in zip(ta, tb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_save_load_roundtrip(tmp_path, g_np):
    p = str(tmp_path / "g.npz")
    order = np.arange(g_np.num_src_nodes)[::-1].copy()
    save_graph(p, g_np, aux={"order": order})
    g2, aux = load_graph(p)
    _assert_graph_equal(g_np, g2)
    _assert_graph_equal(g_np.reverse, g2.reverse)
    np.testing.assert_array_equal(aux["order"], order)


def test_cached_graph_hits(tmp_path, g_np, rng):
    calls = []

    def build():
        calls.append(1)
        return g_np, {"order": np.arange(5)}

    g1, a1 = cached_graph(build, str(tmp_path), "mini_s1.0")
    g2, a2 = cached_graph(build, str(tmp_path), "mini_s1.0")
    assert len(calls) == 1  # second call served from disk
    _assert_graph_equal(g1, g2)
    np.testing.assert_array_equal(a1["order"], a2["order"])
    # different key -> rebuild
    cached_graph(build, str(tmp_path), "mini_s0.5")
    assert len(calls) == 2


def test_cached_graph_corrupt_file_rebuilds(tmp_path, g_np):
    def build():
        return g_np, {}

    g1, _ = cached_graph(build, str(tmp_path), "k")
    files = list(tmp_path.glob("graph_*.npz"))
    assert len(files) == 1
    files[0].write_bytes(b"not an npz")
    g2, _ = cached_graph(build, str(tmp_path), "k")
    _assert_graph_equal(g1, g2)


def test_cached_graph_numerics_identical(tmp_path, rng):
    """An op on the cached graph must produce bitwise-identical output to
    the freshly built graph (the cache stores every reduction-plan array)."""
    import jax.numpy as jnp

    from dgl_jax.ops import gspmm

    n, e = 200, 3000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)

    def build():
        return dgl_jax.from_edges(src, dst, n, device=False), {}

    g_fresh = dgl_jax.from_edges(src, dst, n)
    g_cached, _ = cached_graph(build, str(tmp_path), "num")
    g_cached, _ = cached_graph(build, str(tmp_path), "num")  # from disk
    x = jnp.asarray(rng.standard_normal((n, 16)).astype(np.float32))
    a = gspmm(g_fresh, "copy_u", "mean", x=x)
    b = gspmm(g_cached, "copy_u", "mean", x=x)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
