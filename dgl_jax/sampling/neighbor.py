"""Host-side neighbor sampling producing static-shape bipartite blocks.

Equivalent of DGL's C++ sampling stack
(``dgl.dataloading.sample_neighbors`` → ``to_block`` composition shown in the
reference at ``ns-gat-dgl.py:22-42``; ``MultiLayerNeighborSampler`` +
``NodeDataLoader`` at ``ns-sage-dgl.py:132-141``).

Design differences, deliberate (static shapes for XLA):

* **Sampling with replacement, exactly `fanout` per seed** (the reference's
  products sampler also uses ``replace=True``): every block then has the
  *static* shape ``num_dst = B``, ``num_src = B + B·fanout``,
  ``E = B·fanout`` — one compiled program for the whole epoch.
* **No src-node deduplication.** DGL compacts unique neighbors to minimise
  the host feature gather + H2D copy. Here the full feature matrix stays
  device-resident and the per-step gather is a device row-gather whose cost
  at minibatch scale is microseconds — dedup would only destroy shape
  stability. Seeds occupy the first ``B`` src slots (so ``h_dst = h[:B]``,
  same convention as ``ns-sage-dgl.py:51-57``).
* Edges are generated seed-major so ``dst`` is already sorted — block
  construction is O(E) with no sort.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..graph.graph import Graph, pad_length
from .dataloader import prefetch

__all__ = ["CSRGraph", "MultiLayerNeighborSampler", "NodeDataLoader", "MiniBatch"]


@dataclasses.dataclass
class CSRGraph:
    """Host CSC (in-edge) adjacency for sampling: in-neighbors of node v are
    ``indices[indptr[v]:indptr[v+1]]``."""

    indptr: np.ndarray
    indices: np.ndarray
    num_nodes: int

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> "CSRGraph":
        from ..csrc import native

        indptr, indices, _ = native.build_csr(
            np.asarray(dst, np.int64), np.asarray(src, np.int64), num_nodes
        )
        return CSRGraph(indptr, indices, num_nodes)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MiniBatch:
    """One sampled step: blocks are innermost-last (apply in list order).

    Registered as a pytree so minibatches can be jit arguments and stacked
    for data-parallel replicas (``parallel.dp.stack_minibatches``).
    """

    blocks: List[Graph]
    input_nodes: jnp.ndarray  # (num_src of outermost block,) int32
    seeds: jnp.ndarray  # (B,) int32, padded with 0
    seed_mask: jnp.ndarray  # (B,) bool — False for padding seeds

    def tree_flatten(self):
        return (tuple(self.blocks), self.input_nodes, self.seeds, self.seed_mask), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        blocks, input_nodes, seeds, seed_mask = leaves
        return cls(list(blocks), input_nodes, seeds, seed_mask)


class MultiLayerNeighborSampler:
    """Fanout-per-layer sampler (fanouts listed outermost-first, like DGL's
    ``MultiLayerNeighborSampler([10, 25])`` in ``ns-sage-dgl.py:132``)."""

    def __init__(self, fanouts: Sequence[int], replace: bool = True):
        # replace=False gives DGL's without-replacement semantics (the
        # reference reddit NS default, ``ns-sage-dgl.py:132``): fanout
        # DISTINCT neighbors per seed. Static shapes are kept by filling
        # the slots of deg<fanout seeds cyclically with their (all-distinct)
        # neighbor set — mean aggregation then matches DGL's up to the
        # ±1-repeat weighting when deg does not divide fanout; sum
        # aggregation over-counts by ~fanout/deg for those low-degree seeds.
        # High-degree seeds (the common case at NS fanouts 10/25) are exact.
        self.replace = replace
        self.fanouts = list(fanouts)
        # block skeletons keyed by b_pad: the positional-slot block layout
        # (src/dst/eid/indptr and the analytic transpose) depends only on
        # (n_dst, fanout) — NOT on the sampled data. Rebuilding it per step
        # would re-upload ~5MB of constant arrays every minibatch; cached
        # device-resident blocks make the per-step H2D just
        # input_nodes/seeds/mask.
        self._skel = {}

    def sample_layer(
        self, csr: CSRGraph, seeds: np.ndarray, fanout: int, rng: np.random.Generator
    ) -> np.ndarray:
        """(len(seeds), fanout) sampled in-neighbor ids; rows of zero-degree
        seeds reference the seed itself (self-message keeps shapes static and
        contributes the node's own state, matching DGL's isolated-node
        behavior under replace sampling as closely as possible)."""
        from ..csrc import native

        fn = (native.sample_neighbors if self.replace
              else native.sample_neighbors_noreplace)
        return fn(
            csr.indptr, csr.indices, seeds, fanout,
            int(rng.integers(0, 2**63 - 1)),
        )

    def skeleton_blocks(self, b_pad: int) -> List[Graph]:
        """Device-resident block list for batch size ``b_pad`` (cached).

        Edges connect neighbor slot (n_dst + i·fanout + j) → dst i; seed-
        major generation means BOTH src and dst are already ascending, so
        the forward block and its analytic transpose share the same edge
        order and everything stays sort-free. The layout is independent of
        WHICH nodes were sampled, so one structure serves every step."""
        blocks = self._skel.get(b_pad)
        if blocks is not None:
            return blocks
        blocks = []
        n_dst = b_pad
        for fanout in reversed(self.fanouts):
            n_src = n_dst + n_dst * fanout
            n_e = n_dst * fanout
            e_pad = pad_length(n_e)
            e_src = np.full(e_pad, n_src, dtype=np.int32)
            e_src[:n_e] = n_dst + np.arange(n_e)
            e_dst = np.full(e_pad, n_dst, dtype=np.int32)
            e_dst[:n_e] = np.repeat(np.arange(n_dst), fanout)
            eid = np.arange(e_pad, dtype=np.int32)
            indptr = np.zeros(n_dst + 1, dtype=np.int32)
            indptr[1:] = np.cumsum(np.full(n_dst, fanout))
            # analytic transpose: in-degree 0 for the first n_dst src slots,
            # 1 for every neighbor slot
            rev_indptr = np.maximum(0, np.arange(n_src + 1, dtype=np.int32) - n_dst)
            rev = Graph(
                src=jnp.asarray(e_dst),
                dst=jnp.asarray(e_src),
                indptr=jnp.asarray(rev_indptr),
                eid=jnp.asarray(eid),
                num_src_nodes=n_dst,
                num_dst_nodes=n_src,
                num_edges=n_e,
                reverse=None,
            )
            blocks.append(Graph(
                src=jnp.asarray(e_src),
                dst=jnp.asarray(e_dst),
                indptr=jnp.asarray(indptr),
                eid=jnp.asarray(eid),
                num_src_nodes=n_src,
                num_dst_nodes=n_dst,
                num_edges=n_e,
                reverse=rev,
                block_fanout=fanout,
            ))
            n_dst = n_src
        blocks.reverse()
        self._skel[b_pad] = blocks
        return blocks

    def sample(
        self, csr: CSRGraph, seeds: np.ndarray, rng: np.random.Generator, b_pad: int
    ) -> MiniBatch:
        b = len(seeds)
        seeds_p = np.zeros(b_pad, dtype=np.int64)
        seeds_p[:b] = seeds
        mask = np.zeros(b_pad, dtype=bool)
        mask[:b] = True

        blocks = self.skeleton_blocks(b_pad)
        cur = seeds_p
        # innermost-first construction (like ns-gat-dgl.py:40 reversal)
        for fanout in reversed(self.fanouts):
            nbrs = self.sample_layer(csr, cur, fanout, rng)  # (len(cur), fanout)
            # src list = dst nodes first, then sampled neighbors
            cur = np.concatenate([cur, nbrs.reshape(-1)])
        return MiniBatch(
            blocks=blocks,
            input_nodes=jnp.asarray(cur.astype(np.int32)),
            seeds=jnp.asarray(seeds_p.astype(np.int32)),
            seed_mask=jnp.asarray(mask),
        )


class NodeDataLoader:
    """Shuffled seed-batch iterator with background sampling.

    Equivalent of ``dgl.dataloading.NodeDataLoader`` (``ns-sage-dgl.py:
    134-141``): shuffling, fixed batch shapes (last batch padded), prefetch
    thread standing in for worker processes.
    """

    def __init__(
        self,
        csr: CSRGraph,
        nids: np.ndarray,
        sampler: MultiLayerNeighborSampler,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        prefetch_depth: int = 3,
    ):
        self.csr = csr
        self.nids = np.asarray(nids)
        self.sampler = sampler
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch_depth = prefetch_depth

    def __len__(self):
        n = len(self.nids)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _gen(self) -> Iterator[MiniBatch]:
        idx = self.nids.copy()
        if self.shuffle:
            self.rng.shuffle(idx)
        stop = len(idx) - (len(idx) % self.batch_size) if self.drop_last else len(idx)
        for i in range(0, stop, self.batch_size):
            seeds = idx[i : i + self.batch_size]
            yield self.sampler.sample(self.csr, seeds, self.rng, self.batch_size)

    def __iter__(self):
        return prefetch(self._gen(), self.prefetch_depth)
