"""Mesh-sharded execution: the distribution layer the reference lacks.

The reference has **no** parallelism (SURVEY §2.2) — its answer to memory
limits is sampling, and full-graph training simply OOMs (README.md:43,46).
This module adds the answer (BASELINE north star): partition the graph
across a device mesh and let XLA insert the collectives.

Two composable axes:

* ``graph`` — edge/node partition (the GNN analogue of sequence/context
  parallelism): edge arrays sharded on the edge dim, node-aligned arrays
  sharded on the node dim, parameters replicated. The SpMM scatter becomes
  per-shard partial sums + cross-shard reduction (XLA GSPMD inserts the
  all-reduce; the explicit shard_map halo path lives in ``halo.py``).
* ``data`` — replica axis for sampled-minibatch data parallelism
  (gradient all-reduce).

Everything here works on any jax backend — the test suite exercises an
8-device virtual CPU mesh (``tests/conftest.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.graph import Graph

__all__ = [
    "device_mesh",
    "replicated",
    "graph_sharding",
    "node_sharding",
    "shard_graph",
]


def device_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data", "graph"),
    *,
    devices=None,
) -> Mesh:
    """Build a mesh over available devices; default shape (1, n_devices)."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def node_sharding(mesh: Mesh, axis: str = "graph") -> NamedSharding:
    """Shard a node-aligned array's leading dim across ``axis``."""
    return NamedSharding(mesh, P(axis))


def graph_sharding(g: Graph, mesh: Mesh, axis: str = "graph"):
    """A sharding pytree matching :class:`Graph`'s full structure: arrays
    with the padded edge length shard on the edge dim, everything else
    (indptr, piece tables, nested aux) replicates.

    Use with ``jax.device_put(g, graph_sharding(g, mesh))`` or as
    ``in_shardings`` for a jitted step. Requires the padded edge count to
    divide by the axis size (pad with ``from_edges(..., e_pad=...)``).
    """
    edge = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    e_pad = g.num_edges_padded

    return jax.tree_util.tree_map(
        lambda leaf: edge
        if (hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] == e_pad)
        else rep,
        g,
    )


def shard_graph(g: Graph, mesh: Mesh, axis: str = "graph") -> Graph:
    """Place a Graph's arrays onto the mesh with edge-partition sharding."""
    return jax.device_put(g, graph_sharding(g, mesh, axis))
