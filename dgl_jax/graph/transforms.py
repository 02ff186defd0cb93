"""Host-side graph transforms (NumPy).

Equivalents of the DGL structure transforms the reference suite uses:
``dgl.to_bidirected`` (``main_dgl_arxiv_sage.py:162``), ``add_self_loop`` /
``remove_self_loop`` (``main_dgl_arxiv_gat.py:130-131``,
``cluster-gat/dgl/sampler.py:56-57``), node-induced subgraph with NID mapping
(``cluster-sage/dgl/sampler.py:65-66``, ``load_graph.py:46-48``).

These run once at preprocessing time on the host, so plain vectorised NumPy
is the right tool; only the resulting static-shape :class:`Graph` touches the
device. All functions work on raw (src, dst) edge arrays and there are ``*_graph``
wrappers that rebuild a :class:`Graph`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .graph import Graph, from_edges

__all__ = [
    "coalesce",
    "to_bidirected",
    "add_self_loops",
    "remove_self_loops",
    "node_subgraph",
    "reindex",
    "to_bidirected_graph",
    "add_self_loops_graph",
]


def coalesce(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sort + dedup duplicate edges (DGL ``to_bidirected`` semantics dedup)."""
    key = src.astype(np.int64) * num_nodes + dst.astype(np.int64)
    key = np.unique(key)
    return (key // num_nodes).astype(src.dtype), (key % num_nodes).astype(dst.dtype)


def to_bidirected(src, dst, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Union of edges and their reverses, deduplicated."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    return coalesce(s, d, num_nodes)


def remove_self_loops(src, dst) -> Tuple[np.ndarray, np.ndarray]:
    keep = src != dst
    return src[keep], dst[keep]


def add_self_loops(src, dst, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Append (v, v) for every node (after removing existing self loops,
    matching DGL's remove+add idiom)."""
    src, dst = remove_self_loops(src, dst)
    loop = np.arange(num_nodes, dtype=src.dtype if len(src) else np.int32)
    return np.concatenate([src, loop]), np.concatenate([dst, loop])


def reindex(ids: np.ndarray, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Compact a set of node ids.

    Returns (unique_ids, mapping) where ``mapping`` is a dense array of size
    ``num_nodes`` with new index per old id (undefined for absent ids).
    """
    uniq = np.unique(ids)
    mapping = np.zeros(num_nodes, dtype=np.int64)
    mapping[uniq] = np.arange(len(uniq))
    return uniq, mapping


def node_subgraph(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    nodes: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Node-induced subgraph.

    Returns (sub_src, sub_dst, nodes) with edges relabelled to positions in
    ``nodes`` (which plays the role of DGL's ``NID`` mapping).
    """
    nodes = np.asarray(nodes)
    present = np.zeros(num_nodes, dtype=bool)
    present[nodes] = True
    keep = present[src] & present[dst]
    mapping = np.zeros(num_nodes, dtype=np.int64)
    mapping[nodes] = np.arange(len(nodes))
    return mapping[src[keep]], mapping[dst[keep]], nodes


# -- Graph-level wrappers --------------------------------------------------


def _edges_of(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    return g.edges_numpy()


def to_bidirected_graph(g: Graph, **kwargs) -> Graph:
    s, d = to_bidirected(*_edges_of(g), g.num_nodes)
    return from_edges(s, d, g.num_nodes, **kwargs)


def add_self_loops_graph(g: Graph, **kwargs) -> Graph:
    s, d = add_self_loops(*_edges_of(g), g.num_nodes)
    return from_edges(s, d, g.num_nodes, **kwargs)
