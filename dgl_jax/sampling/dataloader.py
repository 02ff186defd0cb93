"""Host-side minibatch loaders with prefetch.

Replacement for the reference's torch ``GraphDataLoader`` /
``DataLoader`` worker-process pipelines (``main_dgl_enzymes_gcn.py:165``,
``cluster-sage/dgl/main.py:231``): collation runs in vectorised NumPy on the
host, batches are padded to fixed bucket shapes (one compiled program per
bucket), and a background thread overlaps collation with device compute
(the analogue of ``num_workers`` prefetch).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

import jax.numpy as jnp

from ..graph.batch import GraphBatch, batch_graphs
from ..graph.graph import pad_length
from ..memory import memory_share

__all__ = ["prefetch", "GraphBatchLoader"]


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate into consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield item


class GraphBatchLoader:
    """Batched-graph loader for graph classification.

    Pads every batch to one global (num_graphs, n_pad, e_pad) bucket so the
    whole epoch reuses a single compiled train step. Node/edge features are
    collated into the batch's canonical edge order.
    """

    def __init__(
        self,
        graphs: Sequence[Tuple[np.ndarray, np.ndarray, int]],
        node_feats: Sequence[np.ndarray],
        labels: np.ndarray,
        batch_size: int,
        *,
        edge_feats: Optional[Sequence[Optional[np.ndarray]]] = None,
        shuffle: bool = True,
        seed: int = 0,
        n_pad: Optional[int] = None,
        e_pad: Optional[int] = None,
        prefetch_depth: int = 2,
    ):
        self.graphs = graphs
        self.node_feats = node_feats
        self.edge_feats = edge_feats
        self.labels = np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch_depth = prefetch_depth

        # worst-case bounds for an ARBITRARY shuffled batch: the top
        # batch_size graphs by node count / by edge count respectively
        # (independent orders — a batch can maximize either axis)
        sizes_n = np.sort(np.array([g[2] for g in graphs]))[::-1]
        sizes_e = np.sort(np.array([len(g[0]) for g in graphs]))[::-1]
        nb = int(sizes_n[:batch_size].sum()) if len(graphs) else batch_size
        eb = int(sizes_e[:batch_size].sum()) if len(graphs) else batch_size
        self.n_pad = n_pad or pad_length(int(nb))
        self.e_pad = e_pad or pad_length(int(eb))
        self._cache = None  # device-resident epoch cache (see __iter__)

    def __len__(self):
        return (len(self.graphs) + self.batch_size - 1) // self.batch_size

    def _collate(self, idx: np.ndarray):
        gs = [self.graphs[i] for i in idx]
        batch = batch_graphs(
            gs, num_graphs=self.batch_size, n_pad=self.n_pad, e_pad=self.e_pad
        )
        nf = np.concatenate([self.node_feats[i] for i in idx])
        nf_pad = np.zeros((self.n_pad,) + nf.shape[1:], dtype=nf.dtype)
        nf_pad[: len(nf)] = nf
        out_ef = None
        if self.edge_feats is not None and self.edge_feats[idx[0]] is not None:
            ef = np.concatenate([self.edge_feats[i] for i in idx])
            g = batch.graph
            eid = np.asarray(g.eid)
            ef_pad = np.zeros((self.e_pad,) + ef.shape[1:], dtype=ef.dtype)
            valid = eid < len(ef)
            ef_pad[valid] = ef[eid[valid]]  # canonical (dst-sorted) order
            out_ef = jnp.asarray(ef_pad)
        yb = np.zeros(self.batch_size, dtype=self.labels.dtype)
        yb[: len(idx)] = self.labels[idx]
        # LAST collation step: erase the per-batch edge count from the
        # static pytree aux so every same-bucket batch reuses one compiled
        # program (edge validity in jit is sentinel-based)
        import dataclasses

        from ..graph.graph import quantize_trace_meta

        batch = dataclasses.replace(batch, graph=quantize_trace_meta(batch.graph))
        return batch, jnp.asarray(nf_pad), out_ef, jnp.asarray(yb)

    def _epoch_indices(self):
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            yield idx[i : i + self.batch_size]

    def first(self):
        """One batch without spinning up the prefetch thread (for model.init)."""
        return self._collate(np.arange(min(self.batch_size, len(self.graphs))))

    # Device-resident epoch cache. Re-collating per epoch re-uploads each
    # batch's structure arrays (~2-4MB for ogbg-ppa buckets) to the device.
    # Since the collated tuples are jnp (device) arrays, retaining them
    # makes later epochs pure dispatch. Deviation from the reference's
    # per-epoch reshuffle: batch COMPOSITION freezes after epoch 1 and only
    # batch ORDER reshuffles — same batch-level stochasticity, no per-edge
    # resampling (documented). The cache holds at most a quarter of device
    # memory; a bigger epoch keeps streaming.
    def _cache_bytes(self, item) -> int:
        import jax

        return sum(
            getattr(l, "nbytes", 0)
            for l in jax.tree_util.tree_leaves(item)
        )

    def stacked_cache(self):
        """The device-resident epoch cache stacked on a leading step axis
        (one pytree whose leaves are (n_steps, ...) device arrays), or None
        until the cache exists (run one epoch first) or if the epoch was too
        big to cache. Enables scanning a whole epoch of train steps in ONE
        dispatch (`--scan-steps` in the GC driver): the per-step dispatch
        latency (×514 steps/epoch on molhiv) leaves the hot path entirely;
        a step's batch is gathered on-device from the stack by a traced
        index."""
        if getattr(self, "_cache", None) is None:
            return None
        import dataclasses

        import jax

        from ..graph.graph import repad_graph_pieces

        # uniformize the data-dependent piece-array lengths (half-octave
        # buckets diverge on small final batches) by sentinel-extension, so
        # every leaf stacks; everything else is already bucket-uniform
        items = self._cache

        def lens(it):
            g = it[0].graph
            return (g.segblocks[0].shape[0], g.reverse.segblocks[0].shape[0])

        all_lens = [lens(it) for it in items]
        target = tuple(max(c) for c in zip(*all_lens))
        fixed = []
        for it, l in zip(items, all_lens):
            if l != target:
                batch = it[0]
                g2 = repad_graph_pieces(batch.graph, *target)
                it = (dataclasses.replace(batch, graph=g2),) + tuple(it[1:])
            fixed.append(it)
        stacked = jax.tree_util.tree_map(
            lambda *ls: jnp.stack(ls), *fixed)
        return stacked, len(fixed)

    def __iter__(self):
        if getattr(self, "_cache", None) is not None:
            order = self.rng.permutation(len(self._cache))
            return iter([self._cache[i] for i in order])

        def gen():
            budget = memory_share(1 / 4)
            cache = []
            total = 0
            for b in self._epoch_indices():
                item = self._collate(b)
                if cache is not None:
                    total += self._cache_bytes(item)
                    if total <= budget:
                        cache.append(item)
                    else:
                        cache = None  # too big: stay streaming
                yield item
            if cache is not None:
                self._cache = cache

        return prefetch(gen(), self.prefetch_depth)
