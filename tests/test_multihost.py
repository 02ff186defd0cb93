"""Multi-host validation: two REAL processes on the CPU backend form a
distributed jax cluster and run sharded SpMM with cross-process collectives
(SURVEY §4's 'multi-host tests runnable on CPU' requirement)."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.environ["DGL_JAX_REPO"])

from dgl_jax.parallel.multihost import initialize, global_mesh
initialize()  # from DGL_JAX_* env vars

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import dgl_jax
from dgl_jax.ops import gspmm
from dgl_jax.parallel import shard_graph

assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4  # 2 procs x 2 virtual cpu devices

mesh = global_mesh(("data", "graph"))
assert mesh.devices.shape == (2, 2)

rng = np.random.default_rng(0)
n, e, d = 64, 256, 8
src = rng.integers(0, n, e)
dst = rng.integers(0, n, e)
g = dgl_jax.from_edges(src, dst, n, e_pad=256)
x_np = rng.standard_normal((n, d)).astype(np.float32)

# single-process reference computed identically on both hosts
ref = np.asarray(gspmm(g, "copy_u", "mean", x=jnp.asarray(x_np)))

# shard edges across all 4 devices (data x graph flattened via 2 axes)
from jax.sharding import PartitionSpec
from dgl_jax.parallel.spmd import graph_sharding
gs = graph_sharding(g, mesh, "graph")
# host-local construction of globally-sharded arrays
from jax import make_array_from_callback
def put(arr, spec):
    sh = NamedSharding(mesh, spec)
    return make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])
import jax.tree_util as jtu
g_sh = jtu.tree_map(lambda leaf, shard: put(np.asarray(leaf), shard.spec), g, gs)
x = put(x_np, P("graph"))
out = jax.jit(lambda g, x: gspmm(g, "copy_u", "mean", x=x),
              out_shardings=NamedSharding(mesh, P()))(g_sh, x)
np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-6)
print(f"proc {jax.process_index()}: multihost spmm OK", flush=True)
"""


@pytest.mark.skipif(os.environ.get("DGL_JAX_SKIP_MULTIHOST") == "1",
                    reason="multihost disabled")
def test_two_process_cluster(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            DGL_JAX_REPO=REPO,
            DGL_JAX_COORDINATOR=f"127.0.0.1:{port}",
            DGL_JAX_NUM_PROCESSES="2",
            DGL_JAX_PROCESS_ID=str(pid),
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
        assert "multihost spmm OK" in out
