"""Oracle sweep of gspmm and edge_softmax over op, reduce, width, dtype,
with sentinel edge padding, zero in-degree nodes and gradients.

Values are checked against the dense NumPy oracles of ``tests/utils.py``;
gradients against ``jax.grad`` of a plain segment-op composition over the
input-order edges (no Graph, no custom VJP)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dgl_jax import from_edges
from dgl_jax.graph.graph import pad_length
from dgl_jax.ops import edge_softmax, gspmm

from utils import dense_edge_softmax, dense_spmm

N, E, N_TARGET = 30, 90, 20  # nodes N_TARGET..N-1 have zero in-degree
# bf16 keeps 8 mantissa bits: a sum of ~5 rounded terms is good to ~1e-2
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _graph():
    rng = np.random.default_rng(11)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N_TARGET, E)
    # two extra blocks of sentinel padding past the real edges
    g = from_edges(src, dst, N, e_pad=pad_length(E) + 256)
    return g, src, dst, rng


def _round(a, dtype):
    """The values ``a`` takes in ``dtype`` (the oracle sees what the op sees)."""
    return np.asarray(jnp.asarray(a, dtype).astype(jnp.float32))


def _plain_spmm(x, e, src, dst, op, reduce):
    xe = x[src]
    msg = {"copy_u": xe, "mul": xe * e if e is not None else None,
           "add": xe + e if e is not None else None}[op]
    if reduce == "max":
        m = jax.ops.segment_max(msg, dst, num_segments=N)
        return jnp.where(jnp.isfinite(m), m, 0.0)
    s = jax.ops.segment_sum(msg, dst, num_segments=N)
    if reduce == "mean":
        deg = jax.ops.segment_sum(jnp.ones(len(dst)), dst, num_segments=N)
        s = s / jnp.maximum(deg, 1.0)[:, None]
    return s


CASES = [("copy_u", "sum"), ("copy_u", "mean"), ("copy_u", "max"),
         ("mul", "sum"), ("mul", "mean"), ("add", "sum")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [1, 16, 41])
@pytest.mark.parametrize("op,reduce", CASES)
def test_gspmm_oracle_sweep(op, reduce, width, dtype):
    g, src, dst, rng = _graph()
    x = _round(rng.standard_normal((N, width)), dtype)
    e = None
    if op == "mul":  # u_mul_e with a scalar weight per edge
        e = _round(rng.standard_normal((E, 1)), dtype)
    elif op == "add":
        e = _round(rng.standard_normal((E, width)), dtype)
    xd = jnp.asarray(x, dtype)
    ed = None if e is None else g.permute_edata(jnp.asarray(e, dtype))

    out = gspmm(g, op, reduce, x=xd, e=ed)
    assert out.shape == (N, width)
    ref = dense_spmm(src, dst, N, N, x, e, op, reduce)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, **TOL[dtype])
    # zero in-degree rows are exactly 0 (DGL semantics), padding dropped
    assert np.all(np.asarray(out, np.float32)[N_TARGET:] == 0.0)

    ct = jnp.asarray(rng.standard_normal((N, width)), jnp.float32)
    gx = jax.grad(lambda x: jnp.sum(gspmm(g, op, reduce, x=x, e=ed)
                                    .astype(jnp.float32) * ct))(xd)
    ref_gx = jax.grad(lambda x: jnp.sum(_plain_spmm(
        x, None if e is None else jnp.asarray(e), src, dst, op, reduce) * ct))(
            jnp.asarray(x))
    assert gx.dtype == xd.dtype
    np.testing.assert_allclose(np.asarray(gx, np.float32), ref_gx, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bound", [None, "tight", "loose"])
@pytest.mark.parametrize("heads", [1, 8])
def test_edge_softmax_oracle_sweep(heads, bound, dtype):
    g, src, dst, rng = _graph()
    z = _round(3.0 * rng.standard_normal((E, heads)), dtype)
    seg_max = np.full((N, heads), -np.inf)
    np.maximum.at(seg_max, dst, z)
    seg_max = np.where(np.isfinite(seg_max), seg_max, 0.0).astype(np.float32)
    # tight: the true per-destination max + 1 (bound-shift path); loose: +200,
    # every exp underflows and the exact fallback must take over
    db = None if bound is None else jnp.asarray(
        seg_max + (1.0 if bound == "tight" else 200.0), dtype)
    zc = g.permute_edata(jnp.asarray(z, dtype))
    eid = np.asarray(g.eid)[:E]
    pos = np.empty(E, np.int64)
    pos[eid] = np.arange(E)

    alpha = edge_softmax(g, zc, dst_bound=db)
    ref = dense_edge_softmax(src, dst, N, z.astype(np.float64))
    np.testing.assert_allclose(np.asarray(alpha, np.float32)[:E][pos], ref,
                               **TOL[dtype])

    ct = rng.standard_normal((E, heads)).astype(np.float32)
    ctc = g.permute_edata(jnp.asarray(ct))
    gz = jax.grad(lambda z: jnp.sum(edge_softmax(g, z, dst_bound=db)
                                    .astype(jnp.float32) * ctc))(zc)

    def plain(z):
        m = jax.ops.segment_max(z, dst, num_segments=N)
        ez = jnp.exp(z - m[dst])
        return ez / jax.ops.segment_sum(ez, dst, num_segments=N)[dst]

    ref_gz = jax.grad(lambda z: jnp.sum(plain(z) * ct))(jnp.asarray(z))
    assert np.all(np.isfinite(np.asarray(gz, np.float32)))
    np.testing.assert_allclose(np.asarray(gz, np.float32)[:E][pos], ref_gz,
                               **TOL[dtype])
