"""Multi-host initialization and mesh construction.

The reference is strictly single-GPU (SURVEY §2.2). This module provides the
multi-host entry point: call :func:`initialize` once per process before any
jax usage, then build meshes with :func:`global_mesh` — axis order puts the
data/graph axes outermost so collectives on them cross hosts while inner
axes stay within a host.

Validated end-to-end without accelerators by ``tests/test_multihost.py``,
which launches real separate processes on the CPU backend
(``jax.distributed`` + gloo-style coordinator) and runs sharded SpMM with
cross-process collectives.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["initialize", "global_mesh"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """``jax.distributed.initialize`` with env-var fallbacks
    (DGL_JAX_COORDINATOR / DGL_JAX_NUM_PROCESSES / DGL_JAX_PROCESS_ID).
    Without a cluster environment that JAX detects, the coordinator address,
    process count and process id must be given."""
    import jax

    kwargs = {}
    coordinator_address = coordinator_address or os.environ.get("DGL_JAX_COORDINATOR")
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is None and os.environ.get("DGL_JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["DGL_JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("DGL_JAX_PROCESS_ID"):
        process_id = int(os.environ["DGL_JAX_PROCESS_ID"])
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(axis_names: Sequence[str] = ("data", "graph")):
    """Mesh over ALL processes' devices: first axis spans processes (DCN),
    remaining axes the per-process devices (ICI)."""
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    n_proc = jax.process_count()
    per_proc = len(devices) // n_proc
    if len(axis_names) == 1:
        return Mesh(devices, axis_names)
    shape = (n_proc,) + (per_proc,) + (1,) * (len(axis_names) - 2)
    return Mesh(devices.reshape(shape), axis_names)
