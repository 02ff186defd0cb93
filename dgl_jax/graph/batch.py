"""Batched graphs: block-diagonal merge + segment readout.

Equivalent of DGL's batched-graph representation
(``GraphDataLoader`` + ``dgl.nn.AvgPooling`` in
``main_dgl_enzymes_gcn.py:62,165``) and PyG's ``global_mean_pool``
(``main_pyg_enzymes_gcn.py:11``).

A :class:`GraphBatch` is one :class:`Graph` whose node/edge sets are the
disjoint union of the member graphs, plus a per-node graph id used for
segment readout. Node and edge counts are padded to bucket sizes so one
compiled program serves every batch of a bucket (static-shape discipline —
SURVEY §7 step 4's "hard part").
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .graph import Graph, from_edges, pad_length
from ..ops.segment import segment_mean, segment_sum, segment_max

__all__ = ["GraphBatch", "batch_graphs", "readout"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A block-diagonal batch of graphs.

    graph:     merged :class:`Graph` over padded node count N_pad.
    node_gid:  (N_pad,) int32 — graph id per node; padding nodes hold
               ``num_graphs`` (dropped by segment readout).
    num_graphs: static int (padded graph-slot count).
    num_nodes_per_graph: (num_graphs,) int32 — valid node counts (0 for
               padded graph slots).
    """

    graph: Graph
    node_gid: jnp.ndarray
    num_nodes_per_graph: jnp.ndarray
    num_graphs: int

    def tree_flatten(self):
        return (self.graph, self.node_gid, self.num_nodes_per_graph), (self.num_graphs,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        graph, node_gid, nnpg = leaves
        return cls(graph, node_gid, nnpg, aux[0])

    @property
    def num_nodes_padded(self) -> int:
        return self.graph.num_dst_nodes

    def graph_mask(self, dtype=jnp.float32) -> jnp.ndarray:
        """(num_graphs,) — 1 for real graphs, 0 for padded graph slots."""
        return (self.num_nodes_per_graph > 0).astype(dtype)


def batch_graphs(
    graphs: Sequence[Tuple[np.ndarray, np.ndarray, int]],
    *,
    num_graphs: Optional[int] = None,
    n_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    pad_multiple: int = 128,
    build_reverse: bool = True,
) -> GraphBatch:
    """Merge ``(src, dst, num_nodes)`` triples into one padded batch.

    ``num_graphs``/``n_pad``/``e_pad`` fix the compiled shape; pass bucket
    sizes from the dataloader to bound recompilation.
    """
    n_graphs = len(graphs)
    if num_graphs is None:
        num_graphs = n_graphs
    if num_graphs < n_graphs:
        raise ValueError("num_graphs smaller than batch")

    srcs, dsts, gids, counts = [], [], [], []
    offset = 0
    for i, (s, d, n) in enumerate(graphs):
        srcs.append(np.asarray(s, dtype=np.int64) + offset)
        dsts.append(np.asarray(d, dtype=np.int64) + offset)
        gids.append(np.full(n, i, dtype=np.int32))
        counts.append(n)
        offset += n
    total_nodes = offset
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)

    if n_pad is None:
        n_pad = pad_length(total_nodes, pad_multiple)
    if n_pad < total_nodes:
        raise ValueError(f"n_pad={n_pad} < total nodes {total_nodes}")

    # Piece arrays stay data-dependent-sized here (a worst-case uniform pad
    # ~tripled ppa batch memory and blew the device-cache budget);
    # scan-over-steps uniformity is
    # restored at stack time by repad_graph_pieces (sentinel-extension).
    g = from_edges(
        src,
        dst,
        num_src_nodes=n_pad,
        num_dst_nodes=n_pad,
        e_pad=e_pad,
        pad_multiple=pad_multiple,
        build_reverse=build_reverse,
    )
    node_gid = np.full(n_pad, num_graphs, dtype=np.int32)
    node_gid[:total_nodes] = np.concatenate(gids) if gids else np.zeros(0, np.int32)
    nnpg = np.zeros(num_graphs, dtype=np.int32)
    nnpg[:n_graphs] = np.asarray(counts, dtype=np.int32)
    return GraphBatch(
        graph=g,
        node_gid=jnp.asarray(node_gid),
        num_nodes_per_graph=jnp.asarray(nnpg),
        num_graphs=num_graphs,
    )


def readout(batch: GraphBatch, x: jnp.ndarray, op: str = "mean") -> jnp.ndarray:
    """Per-graph readout of node features: (N_pad, D) → (num_graphs, D).

    ``mean`` matches ``dgl.nn.AvgPooling`` (``main_dgl_enzymes_gcn.py:62``);
    padding nodes are dropped via the out-of-range graph-id sentinel.
    """
    if op == "mean":
        return segment_mean(x, batch.node_gid, batch.num_graphs, sorted=True)
    if op == "sum":
        return segment_sum(x, batch.node_gid, batch.num_graphs, sorted=True)
    if op == "max":
        return segment_max(x, batch.node_gid, batch.num_graphs, sorted=True)
    raise ValueError(f"unknown readout op: {op}")
