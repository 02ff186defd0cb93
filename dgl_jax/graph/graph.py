"""Immutable static-shape graph tensor.

This is the core data structure of the framework — the equivalent of the
graph object the reference suite gets from DGL (``dgl.graph`` /
``dgl.heterograph``; see reference usage at
``end_to_end/full_graph/node_classification/main_dgl_citation_sage.py:190-191``
and format control at ``main_dgl_product_sage.py:158``).

Design (written for XLA, not a port):

* **Immutable pytree.** JAX traces pure functions; DGL's mutable
  ``g.ndata['h'] = x`` style does not fit. A :class:`Graph` is a frozen
  dataclass registered as a pytree; features flow through functional ops
  (``dgl_jax.ops``) instead of being stored on the graph.
* **Static shapes.** XLA compiles one program per shape. Edge arrays are
  padded to a fixed length (multiple of 128 lanes); padded edges carry the
  sentinel ``dst == num_dst_nodes`` so out-of-range scatter *drops* them for
  free inside ``jax.ops.segment_sum`` — no mask multiply on the hot path.
* **dst-sorted canonical order.** All reductions in message passing are
  "reduce by destination"; keeping edges sorted by ``dst`` lets every
  segment reduction use ``indices_are_sorted=True`` and gives CSR-like
  locality. The transpose (needed for backward
  scatter-by-src) is a precomputed ``reverse()`` graph, mirroring how DGL
  keeps CSR+CSC (``.formats(['csr','csc'])``).
* **Bipartite by construction.** ``num_src_nodes``/``num_dst_nodes`` may
  differ, which makes sampled message-flow "blocks"
  (``dgl.to_block`` in ``ns-gat-dgl.py:36``) the same type as full graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "Graph",
    "from_edges",
    "from_scipy_coo",
    "pad_length",
    "quantize_trace_meta",
]

# Edge arrays are padded to a multiple of this, so minibatch graphs fall into
# a few compiled shapes and the blocked segment sum sees whole blocks.
_LANES = 128


def pad_length(n: int, multiple: int = _LANES) -> int:
    """Round ``n`` up to a multiple (minimum one full tile)."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Graph:
    """Static-shape directed (possibly bipartite) graph.

    Arrays (pytree leaves):
      src:      (E_pad,) int32 — source node id per edge, dst-sorted order.
                Padding entries hold ``num_src_nodes`` (clamped on gather,
                dropped on scatter).
      dst:      (E_pad,) int32 — destination node id per edge, ascending.
                Padding entries hold ``num_dst_nodes``.
      indptr:   (num_dst_nodes + 1,) int32 — CSC-style in-edge offsets:
                edges with destination ``v`` live at ``indptr[v]:indptr[v+1]``.
      eid:      (E_pad,) int32 — original (input-order) edge id for each
                stored edge, so edge features supplied in input order can be
                permuted into canonical order (``permute_edata``). Padding
                entries hold ``num_edges`` (the first padded slot).

    Static metadata (aux data, baked into the compiled program):
      num_src_nodes, num_dst_nodes: int
      num_edges: int — number of *valid* edges (≤ E_pad).

    ``reverse`` is the transpose graph (src/dst swapped, re-sorted); it is a
    nested pytree leaf-holder used by backward passes and by ops that reduce
    by source. It is built host-side by :func:`from_edges`.
    """

    src: jnp.ndarray
    dst: jnp.ndarray
    indptr: jnp.ndarray
    eid: jnp.ndarray
    num_src_nodes: int
    num_dst_nodes: int
    num_edges: int
    reverse: Optional["Graph"] = None
    # Sampled blocks with exactly `block_fanout` in-edges per dst node laid
    # out positionally (src slot of edge (i,j) == num_dst + i*fanout + j):
    # their SpMM needs no gather/scatter at all — ops take a reshape-reduce
    # fast path. Set by MultiLayerNeighborSampler.
    block_fanout: Optional[int] = None
    # Piece arrays for the blocked segment sum (seg_id, idx_end, idx_sub):
    # per (segment × 128-edge-block) piece, gather indices into the
    # block-local prefix array. Gives scatter-grade accuracy at near-scan
    # speed (see ops/segment.py:segment_sum_blocked). Built by from_edges.
    segblocks: Optional[Tuple] = None

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        leaves = (
            self.src, self.dst, self.indptr, self.eid, self.reverse,
            self.segblocks,
        )
        aux = (self.num_src_nodes, self.num_dst_nodes, self.num_edges, self.block_fanout)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        src, dst, indptr, eid, reverse, segblocks = leaves
        n_src, n_dst, n_e, bf = aux
        return cls(src, dst, indptr, eid, n_src, n_dst, n_e, reverse, bf,
                   segblocks)

    # -- basic properties --------------------------------------------------
    @property
    def num_nodes(self) -> int:
        """Node count for homogeneous graphs (src set == dst set)."""
        assert self.num_src_nodes == self.num_dst_nodes, (
            "num_nodes is ambiguous on a bipartite graph; use "
            "num_src_nodes / num_dst_nodes"
        )
        return self.num_dst_nodes

    @property
    def num_edges_padded(self) -> int:
        return int(self.src.shape[0])

    @property
    def is_block(self) -> bool:
        return self.num_src_nodes != self.num_dst_nodes

    # -- derived quantities (jit-safe) ------------------------------------
    def in_degrees(self) -> jnp.ndarray:
        """(num_dst_nodes,) int32 — number of valid in-edges per destination.

        Reference capability: ``g.in_degrees()``
        (``main_dgl_enzymes_gcn.py:34``).
        """
        return self.indptr[1:] - self.indptr[:-1]

    def out_degrees(self) -> jnp.ndarray:
        """(num_src_nodes,) int32 — number of valid out-edges per source."""
        if self.reverse is not None:
            return self.reverse.in_degrees()
        ones = jnp.ones(self.src.shape, dtype=jnp.int32)
        return jax.ops.segment_sum(ones, self.src, num_segments=self.num_src_nodes)

    def edge_mask(self, dtype=jnp.float32) -> jnp.ndarray:
        """(E_pad,) — 1 for valid edges, 0 for padding."""
        return (self.dst < self.num_dst_nodes).astype(dtype)

    def permute_edata(self, edata: jnp.ndarray, fill=0) -> jnp.ndarray:
        """Permute input-order edge features into canonical (dst-sorted) order.

        ``edata`` has leading dim ``num_edges`` (or ``E_pad``); output has
        leading dim ``E_pad`` with ``fill`` in padding slots.
        """
        gathered = jnp.take(edata, jnp.minimum(self.eid, edata.shape[0] - 1), axis=0)
        mask = (self.eid < self.num_edges).reshape((-1,) + (1,) * (edata.ndim - 1))
        return jnp.where(mask, gathered, fill)

    # -- host-side views ---------------------------------------------------
    def edges_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """Valid (src, dst) pairs as host numpy arrays, canonical order."""
        src = np.asarray(self.src)[: self.num_edges]
        dst = np.asarray(self.dst)[: self.num_edges]
        return src, dst

    def __repr__(self) -> str:  # keep noise out of jit traces
        return (
            f"Graph(num_src={self.num_src_nodes}, num_dst={self.num_dst_nodes}, "
            f"num_edges={self.num_edges}, padded={self.num_edges_padded})"
        )


SEG_BLOCK = 128  # block length of the blocked segment sum


def _piece_pad(total: int) -> int:
    """Half-octave piece-count buckets: the piece arrays are pytree LEAVES,
    so their length is a jit cache key — minibatch graphs with the same
    (n_pad, e_pad) bucket must produce identical shapes here too, or every
    batch recompiles (sentinel pieces gather the appended zero row and
    scatter to the dropped segment, so padding is free)."""
    p_pad = pad_length(max(total, 1))
    if p_pad > 128:
        import math

        k = math.ceil(2.0 * math.log2(p_pad / 128.0))
        p_pad = int(math.ceil(128.0 * 2.0 ** (k / 2.0)))
        p_pad += (-p_pad) % 128
    return p_pad


def _build_seg_blocks(
    indptr64: np.ndarray, e_pad: int, piece_pad: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Piece arrays for the blocked segment sum: each piece is the part of a
    segment inside one 128-edge block; its sum is a difference of
    block-LOCAL prefix values (bounded magnitudes → scatter-grade accuracy).

    Returns (seg_id, idx_end, idx_sub) padded to a lane multiple; sentinel
    indices equal e_pad (gathers an appended zero row) and sentinel seg_id
    equals num_segments (dropped by the scatter).
    """
    B = SEG_BLOCK
    n = len(indptr64) - 1
    s = indptr64[:-1].astype(np.int64)
    e = indptr64[1:].astype(np.int64)
    nb = np.where(e > s, (e - 1) // B - s // B + 1, 0)
    total = int(nb.sum())
    p_pad = piece_pad if piece_pad is not None else _piece_pad(total)
    if p_pad < total:
        raise ValueError(f"piece_pad={p_pad} < {total} seg pieces")
    seg_id = np.full(p_pad, n, dtype=np.int32)
    idx_end = np.full(p_pad, e_pad, dtype=np.int32)
    idx_sub = np.full(p_pad, e_pad, dtype=np.int32)
    if total:
        seg = np.repeat(np.arange(n), nb)
        offs = np.concatenate([[0], np.cumsum(nb)])[:-1]
        kk = np.arange(total) - np.repeat(offs, nb)
        k = np.repeat(s // B, nb) + kk
        end = np.minimum(np.repeat(e, nb), (k + 1) * B)
        s_rep = np.repeat(s, nb)
        first = kk == 0
        sub_needed = first & (s_rep % B != 0)
        seg_id[:total] = seg
        idx_end[:total] = end - 1
        idx_sub[:total] = np.where(sub_needed, s_rep - 1, e_pad)
    return seg_id, idx_end, idx_sub


def _build_sorted(
    src: np.ndarray,
    dst: np.ndarray,
    num_src: int,
    num_dst: int,
    e_pad: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sort edges by dst (stable, O(E) native counting sort when available),
    build indptr, pad with sentinels."""
    from ..csrc import native  # lazy: csrc compiles on first use

    num_e = len(src)
    indptr64, src_sorted, order = native.build_csr(
        np.asarray(dst, dtype=np.int64), np.asarray(src, dtype=np.int64), num_dst
    )
    s = np.full(e_pad, num_src, dtype=np.int32)
    d = np.full(e_pad, num_dst, dtype=np.int32)
    e = np.full(e_pad, num_e, dtype=np.int32)
    s[:num_e] = src_sorted
    d[:num_e] = np.repeat(
        np.arange(num_dst, dtype=np.int32), np.diff(indptr64).astype(np.int64)
    )
    e[:num_e] = order
    return s, d, indptr64.astype(np.int32), e


def from_edges(
    src,
    dst,
    num_src_nodes: int,
    num_dst_nodes: Optional[int] = None,
    *,
    e_pad: Optional[int] = None,
    pad_multiple: int = _LANES,
    build_reverse: bool = True,
    device: bool = True,
    piece_pad: Optional[int] = None,
) -> Graph:
    """Build a :class:`Graph` from COO edge lists (host-side).

    Args:
      src, dst: 1-D integer arrays of equal length (input edge order).
      num_src_nodes: source node count; also dst count if ``num_dst_nodes``
        is None (homogeneous graph).
      e_pad: explicit padded edge length (use to bucket minibatches into a
        few compiled shapes); defaults to ``pad_length(len(src))``.
      piece_pad: explicit padded length for the segblocks piece
        arrays. Without it, pieces use data-dependent half-octave buckets
        (``_piece_pad``) — fine for one-off graphs, but bucketed minibatches
        whose piece counts straddle a bucket boundary get different leaf
        shapes (one recompile each, and they can't be stacked for a
        scan-over-steps epoch). Loaders pass the bucket's worst case.
      build_reverse: also build the transpose graph (needed for out-degrees,
        backward scatter and reduce-by-src ops).
      device: wrap leaves as jax arrays (upload). ``False`` keeps numpy
        leaves — used by the disk cache (graph/cache.py) to save without a
        device round-trip; numpy-leaf Graphs work in jit but re-upload per
        call, so convert before a hot loop.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"src/dst must be 1-D and equal length, got {src.shape} vs {dst.shape}")
    if num_dst_nodes is None:
        num_dst_nodes = num_src_nodes
    num_e = int(src.shape[0])
    if num_e and (src.min(initial=0) < 0 or src.max(initial=0) >= num_src_nodes):
        raise ValueError("src ids out of range")
    if num_e and (dst.min(initial=0) < 0 or dst.max(initial=0) >= num_dst_nodes):
        raise ValueError("dst ids out of range")
    if e_pad is None:
        e_pad = pad_length(num_e, pad_multiple)
    if e_pad < num_e:
        raise ValueError(f"e_pad={e_pad} < num_edges={num_e}")

    wrap = jnp.asarray if device else (lambda a: a)
    s, d, indptr, e = _build_sorted(src, dst, num_src_nodes, num_dst_nodes, e_pad)
    segb = tuple(wrap(a) for a in _build_seg_blocks(
        indptr.astype(np.int64), e_pad, piece_pad=piece_pad))
    rev = None
    if build_reverse:
        # Build the transpose from the *canonical* arrays so that rev.eid maps
        # each reverse-canonical slot to the forward-canonical slot of the same
        # edge — this is what lets backward passes permute edge cotangents into
        # src-sorted order and use a sorted segment reduction.
        rs, rd, rindptr, re = _build_sorted(
            d[:num_e], s[:num_e], num_dst_nodes, num_src_nodes, e_pad
        )
        rev_segb = tuple(
            wrap(a) for a in _build_seg_blocks(
                rindptr.astype(np.int64), e_pad, piece_pad=piece_pad)
        )
        rev = Graph(
            src=wrap(rs),
            dst=wrap(rd),
            indptr=wrap(rindptr),
            eid=wrap(re),
            num_src_nodes=num_dst_nodes,
            num_dst_nodes=num_src_nodes,
            num_edges=num_e,
            reverse=None,
            segblocks=rev_segb,
        )
    return Graph(
        src=wrap(s),
        dst=wrap(d),
        indptr=wrap(indptr),
        eid=wrap(e),
        num_src_nodes=num_src_nodes,
        num_dst_nodes=num_dst_nodes,
        num_edges=num_e,
        reverse=rev,
        segblocks=segb,
    )


def _repad_one(g: Graph, seg_pad: int) -> Graph:
    e_pad = int(g.src.shape[0])
    n = g.num_dst_nodes
    seg_id, idx_end, idx_sub = (np.asarray(a) for a in g.segblocks)
    cur = len(seg_id)
    if cur != seg_pad:
        if seg_pad < cur:
            raise ValueError(f"seg piece repad {seg_pad} < current {cur}")
        pad = seg_pad - cur
        seg_id = np.concatenate([seg_id, np.full(pad, n, seg_id.dtype)])
        idx_end = np.concatenate([idx_end, np.full(pad, e_pad, idx_end.dtype)])
        idx_sub = np.concatenate([idx_sub, np.full(pad, e_pad, idx_sub.dtype)])
    wrap = jnp.asarray if isinstance(g.src, jnp.ndarray) else (lambda a: a)
    return dataclasses.replace(
        g, segblocks=(wrap(seg_id), wrap(idx_end), wrap(idx_sub)))


def repad_graph_pieces(g: Graph, seg_pad: int,
                       rev_seg_pad: Optional[int] = None) -> Graph:
    """Extend the data-dependent segblocks piece arrays (and the reverse
    graph's) to the given lengths by appending inert sentinel pieces: they
    gather the appended zero row (`idx == e_pad`) and scatter to the
    dropped segment (`seg_id == num_dst`). Used by loaders to give every
    same-bucket minibatch IDENTICAL leaf shapes (half-octave piece buckets
    otherwise diverge on small final batches) so the epoch cache can be
    stacked and scanned."""
    g2 = _repad_one(g, seg_pad)
    if g.reverse is not None and rev_seg_pad is not None:
        g2 = dataclasses.replace(
            g2, reverse=_repad_one(g.reverse, rev_seg_pad))
    return g2


def quantize_trace_meta(g: Graph) -> Graph:
    """Make the Graph's STATIC pytree aux independent of the true edge count.

    ``num_edges`` sits in the pytree treedef, so two bucketed minibatches
    with IDENTICAL array shapes but different real edge counts are
    different jit cache keys — one XLA compile per batch.
    This replaces ``num_edges`` with ``num_edges_padded`` on the graph and
    its reverse, collapsing every same-bucket batch onto one program.

    Safe because edge validity inside jit is SENTINEL-based
    (``edge_mask`` tests ``dst < num_dst_nodes``; scatters drop sentinel
    dst; ``in_degrees`` reads indptr) — ``num_edges`` only feeds host-side
    views. Call AFTER any ``permute_edata``/``edges_numpy`` use; minibatch
    loaders do this as their last collation step.
    """
    rev = g.reverse
    if rev is not None and rev.num_edges != rev.num_edges_padded:
        rev = dataclasses.replace(rev, num_edges=rev.num_edges_padded)
    return dataclasses.replace(
        g, num_edges=g.num_edges_padded, reverse=rev,
    )


def from_scipy_coo(mat, **kwargs) -> Graph:
    """Build from a ``scipy.sparse`` matrix in (dst, src) = (row, col) sense:
    ``out[row] += in[col]`` like ``A @ x``."""
    coo = mat.tocoo()
    return from_edges(
        coo.col, coo.row, num_src_nodes=int(coo.shape[1]), num_dst_nodes=int(coo.shape[0]), **kwargs
    )
