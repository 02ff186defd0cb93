"""Cluster-GCN style partition-batched iteration.

Equivalent of the reference's ``ClusterIter`` +
``subgraph_collate_fn`` (``cluster-sage/dgl/sampler.py:11-71``) and the
link-prediction variant with negative-edge graphs
(``dgl_cluster_sampler.py:30-109``): each step draws ``batch_size`` random
partitions, extracts the node-induced subgraph, slices features/labels/
masks, and (optionally) builds a uniform-negative edge graph.

Static-shape discipline: subgraph sizes vary per batch, so node/edge counts
are padded to bucket sizes (powers-of-√2 rounding) — a handful of compiled
programs per run instead of one per batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Optional, Tuple

import numpy as np

import jax.numpy as jnp

from ..graph.graph import Graph, from_edges
from ..graph.partition import get_partition_list, partition_assignment
from ..memory import memory_share
from .dataloader import prefetch

__all__ = ["ClusterIter", "ClusterBatch"]


def _bucket(n: int) -> int:
    """Round up to the next half-octave (×√2 steps), then to a multiple of
    128 — bounds distinct compiled shapes at ~2 per size doubling."""
    n = max(n, 128)
    k = math.ceil(2.0 * math.log2(n / 128.0)) if n > 128 else 0
    while True:
        b = int(math.ceil(128.0 * (2.0 ** (k / 2.0))))
        b += (-b) % 128
        if b >= n:
            return b
        k += 1


@dataclasses.dataclass
class ClusterBatch:
    graph: Graph
    nodes: np.ndarray  # original node ids (host, length num_valid_nodes)
    x: jnp.ndarray
    y: jnp.ndarray
    mask: jnp.ndarray  # train mask AND valid-node mask
    neg_graph: Optional[Graph] = None  # link prediction: uniform negatives
    # host-side "any train nodes?" flag: the skip-batch check
    # (cluster-sage main.py:138) must not cost a device sync per step
    has_train: bool = True


class ClusterIter:
    def __init__(
        self,
        name: str,
        src: np.ndarray,
        dst: np.ndarray,
        num_nodes: int,
        features: np.ndarray,
        labels: np.ndarray,
        train_mask: np.ndarray,
        psize: int,
        batch_size: int,
        *,
        method: str = "metis",
        seed: int = 0,
        cache_dir: Optional[str] = None,
        with_negatives: bool = False,
        prefetch_depth: int = 2,
        freeze: bool = False,
    ):
        self.src, self.dst, self.num_nodes = src, dst, num_nodes
        self.features, self.labels, self.train_mask = features, labels, train_mask
        self.psize, self.batch_size = psize, batch_size
        self.rng = np.random.default_rng(seed)
        self.with_negatives = with_negatives
        self.prefetch_depth = prefetch_depth
        # freeze=True: collate ONE random partition grouping, keep the
        # batches device-resident, and reshuffle only the batch ORDER per
        # epoch (the GC loader's cache semantics). Kills the dominant
        # per-epoch cost at products scale — a ~20M-edge host subgraph sort
        # + piece builds + ~1GB upload per batch. Deviation from the reference's
        # per-epoch regrouping (sampler.py:24): batch-level stochasticity
        # keeps only order; documented in ROADMAP.
        self.freeze = freeze
        self._frozen: Optional[List["ClusterBatch"]] = None
        part = partition_assignment(
            src, dst, num_nodes, psize,
            method=method, seed=seed, cache_dir=cache_dir, cache_key=name,
        )
        from ..graph.partition import partition_stats

        self.part_stats = partition_stats(src, dst, part, psize)
        print(
            f"partition[{method}] k={psize}: "
            f"edge_cut={self.part_stats['edge_cut']:.3f} "
            f"balance={self.part_stats['balance']:.2f}"
        )
        self.par_li = get_partition_list(part, psize)
        # host CSR by src + native subgraph extractor (C++ with NumPy
        # fallback — the dgl.node_subgraph role)
        from ..csrc import native

        indptr, dst_sorted, _ = native.build_csr(
            np.asarray(src, np.int64), np.asarray(dst, np.int64), num_nodes
        )
        self._extractor = native.SubgraphExtractor(indptr, dst_sorted, num_nodes)

    def __len__(self):
        return (self.psize + self.batch_size - 1) // self.batch_size

    def _subgraph(self, nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Edges with BOTH endpoints in ``nodes``, relabelled."""
        return self._extractor.extract(nodes)

    def _collate(self, part_ids: np.ndarray, device: bool = True) -> ClusterBatch:
        nodes = np.concatenate([self.par_li[i] for i in part_ids])
        s, d = self._subgraph(nodes)
        n = len(nodes)
        n_pad = _bucket(n)
        e_pad = _bucket(len(s))
        g = from_edges(s, d, n_pad, e_pad=e_pad, device=device)
        arr = jnp.asarray if device else (lambda a: a)
        x = np.zeros((n_pad,) + self.features.shape[1:], dtype=self.features.dtype)
        x[:n] = self.features[nodes]
        y = np.zeros((n_pad,) + self.labels.shape[1:], dtype=self.labels.dtype)
        y[:n] = self.labels[nodes]
        m = np.zeros(n_pad, dtype=bool)
        m[:n] = self.train_mask[nodes]
        neg = None
        if self.with_negatives:
            # uniform negative dst per positive edge (dgl_cluster_sampler.py:97-109)
            neg_dst = self.rng.integers(0, max(n, 1), size=len(s))
            neg = from_edges(s, neg_dst, n_pad, e_pad=e_pad, device=device)
        from ..graph.graph import quantize_trace_meta

        # erase per-batch edge counts from the static aux — same-bucket
        # cluster batches must share one compiled step (see graph.py)
        g = quantize_trace_meta(g)
        if neg is not None:
            neg = quantize_trace_meta(neg)
        return ClusterBatch(
            graph=g, nodes=nodes, x=arr(x), y=arr(y),
            mask=arr(m), neg_graph=neg, has_train=bool(m.any()),
        )

    def first(self) -> ClusterBatch:
        """One batch without the prefetch thread (for model.init)."""
        return self._collate(np.arange(min(self.batch_size, self.psize)))

    def _gen(self) -> Iterator[ClusterBatch]:
        perm = self.rng.permutation(self.psize)
        for i in range(0, self.psize, self.batch_size):
            yield self._collate(perm[i : i + self.batch_size])

    @staticmethod
    def _to_device(b: "ClusterBatch") -> "ClusterBatch":
        import jax

        up = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
        return dataclasses.replace(
            b, graph=up(b.graph), x=jnp.asarray(b.x), y=jnp.asarray(b.y),
            mask=jnp.asarray(b.mask),
            neg_graph=up(b.neg_graph) if b.neg_graph is not None else None,
        )

    def __iter__(self):
        if not self.freeze:
            return prefetch(self._gen(), self.prefetch_depth)
        if self._frozen is None:
            import jax

            # collate ONE grouping host-side (numpy leaves: no device
            # memory is committed before the budget decision — uploading
            # first OOM'd products cluster-GAT against the eval graph)
            perm = self.rng.permutation(self.psize)
            host = [
                self._collate(perm[i: i + self.batch_size], device=False)
                for i in range(0, self.psize, self.batch_size)
            ]
            total = sum(
                getattr(l, "nbytes", 0)
                for b in host
                for l in jax.tree_util.tree_leaves(
                    (b.graph, b.x, b.y, b.mask, b.neg_graph))
            )
            budget = memory_share(3 / 16)
            if total <= budget:
                self._frozen = [self._to_device(b) for b in host]
            else:
                # device budget exceeded: host-frozen — collation (the
                # dominant cost: subgraph extract + sort + piece builds) is
                # still paid once; per-step upload rides the prefetch thread
                print(f"cluster freeze: {total / 2**30:.1f} GiB > budget — "
                      "host-frozen (collated once, re-uploaded per step)")
                self._frozen = host
                self._frozen_host = True
        order = self.rng.permutation(len(self._frozen))
        items = [self._frozen[i] for i in order]
        if getattr(self, "_frozen_host", False):
            return prefetch((self._to_device(b) for b in items),
                            self.prefetch_depth)
        return iter(items)
