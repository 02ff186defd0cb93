"""Device-side neighbor sampling: the whole minibatch pipeline under jit.

The reference's sampling tier (``ns-sage-dgl.py:132-141``) runs DGL's C++
sampler in host worker processes and ships compacted features to the GPU
per step. The host path here (``neighbor.py``) already keeps features
device-resident, but still ships ``input_nodes`` (~1MB) per step and pays a
host↔device round trip per dispatch.

This module moves the sampling itself onto the device: the CSC adjacency
(indptr + indices, int32) lives in HBM (reddit: ~0.5GB), and one jitted
function maps (seeds, rng key) → ``input_nodes`` with exactly the host
sampler's semantics — uniform with replacement, ``fanout`` slots per seed,
zero-in-degree seeds sampling themselves. Combined with the cached block
skeletons the per-step H2D is the seed ids (4KB).

Distribution-equivalent (not bitwise) to ``csrc.native.sample_neighbors``:
both draw uniform in-neighbors with replacement.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ..graph.graph import Graph
from .neighbor import CSRGraph, MiniBatch, MultiLayerNeighborSampler

__all__ = ["DeviceNeighborSampler"]


@partial(jax.jit, static_argnums=(0,))
def _sample_input_nodes(fanouts: tuple, indptr, indices, seeds, key):
    """(seeds, key) → input_nodes, built innermost-first like the host path.

    Per layer: deg = indptr[v+1]-indptr[v]; slot j draws
    indices[indptr[v] + floor(u·deg)] (u ∈ [0,1)), so every in-neighbor is
    equally likely; zero-degree rows fall back to the node itself (the
    self-message convention of ``neighbor.py:sample_layer``)."""
    cur = seeds.astype(jnp.int32)
    for fanout in reversed(tuple(fanouts)):
        key, sub = jax.random.split(key)
        start = jnp.take(indptr, cur)
        deg = jnp.take(indptr, cur + 1) - start
        u = jax.random.uniform(sub, (cur.shape[0], fanout))
        off = jnp.minimum((u * deg[:, None]).astype(jnp.int32),
                          jnp.maximum(deg - 1, 0)[:, None])
        nbr = jnp.take(indices, start[:, None] + off)
        nbr = jnp.where(deg[:, None] > 0, nbr, cur[:, None])
        cur = jnp.concatenate([cur, nbr.reshape(-1)])
    return cur


class DeviceNeighborSampler:
    """Drop-in for ``MultiLayerNeighborSampler`` with on-device sampling.

    ``sample(seeds, key)`` returns a ``MiniBatch`` whose blocks are the
    cached device-resident skeletons and whose ``input_nodes`` is a device
    array produced inside one compiled program.
    """

    def __init__(self, csr: CSRGraph, fanouts: Sequence[int]):
        self.fanouts = tuple(int(f) for f in fanouts)
        self.indptr = jnp.asarray(csr.indptr, jnp.int32)
        self.indices = jnp.asarray(csr.indices, jnp.int32)
        self._host = MultiLayerNeighborSampler(list(self.fanouts))

    def input_nodes(self, seeds, key):
        """Jittable: (b_pad,) seeds + rng key → (n_src_outer,) input ids."""
        return _sample_input_nodes(self.fanouts, self.indptr, self.indices,
                                   seeds, key)

    def skeleton_blocks(self, b_pad: int) -> List[Graph]:
        return self._host.skeleton_blocks(b_pad)

    def sample(self, seeds: np.ndarray, key, b_pad: int) -> MiniBatch:
        b = len(seeds)
        seeds_p = np.zeros(b_pad, dtype=np.int32)
        seeds_p[:b] = seeds
        mask = np.zeros(b_pad, dtype=bool)
        mask[:b] = True
        seeds_d = jnp.asarray(seeds_p)
        return MiniBatch(
            blocks=self.skeleton_blocks(b_pad),
            input_nodes=self.input_nodes(seeds_d, key),
            seeds=seeds_d,
            seed_mask=jnp.asarray(mask),
        )
