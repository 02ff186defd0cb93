"""On-disk cache for built Graph structures (host-prep amortization).

Building a products-scale Graph costs minutes of host work per process
(to_bidirected plus two CSR counting-sort builds on 92M edges), paid again
by every run because each suite row runs in a fresh subprocess (harness
isolation, ``generate_result.py``). The
reference has the same shape of cost and the same cure: DGL caches METIS
partitions to ``.npy`` keyed by dataset+psize
(``cluster-sage/dgl/sampler.py:33-41``); this module applies that protocol
to the whole canonical graph build.

The cache stores every array leaf of a Graph (forward + reverse:
canonical src/dst/eid/indptr and segment-block piece maps) in one
uncompressed npz, which loads in seconds from page cache.

Keying is by construction recipe, not content hash: the builder's inputs
(dataset, seed, scale, transform flags) fully determine the synthetic or
canonical-npz data, so hashing gigabytes of edges again would cost a
meaningful slice of what the cache saves. Callers must put every
build-affecting flag into ``key``; ``_VERSION`` invalidates on layout
changes.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

import numpy as np

import jax.numpy as jnp

from .graph import Graph

__all__ = ["save_graph", "load_graph", "cached_graph"]

_VERSION = "g3"


def _pack(g: Graph, prefix: str, out: dict):
    out[f"{prefix}src"] = np.asarray(g.src)
    out[f"{prefix}dst"] = np.asarray(g.dst)
    out[f"{prefix}indptr"] = np.asarray(g.indptr)
    out[f"{prefix}eid"] = np.asarray(g.eid)
    out[f"{prefix}meta"] = np.asarray(
        [g.num_src_nodes, g.num_dst_nodes, g.num_edges], dtype=np.int64)
    if g.segblocks is not None:
        for i, a in enumerate(g.segblocks):
            out[f"{prefix}segb{i}"] = np.asarray(a)


def _unpack(z, prefix: str, reverse: Optional[Graph]) -> Graph:
    meta = z[f"{prefix}meta"]
    segb = None
    if f"{prefix}segb0" in z.files:
        segb = tuple(jnp.asarray(z[f"{prefix}segb{i}"]) for i in range(3))
    return Graph(
        src=jnp.asarray(z[f"{prefix}src"]),
        dst=jnp.asarray(z[f"{prefix}dst"]),
        indptr=jnp.asarray(z[f"{prefix}indptr"]),
        eid=jnp.asarray(z[f"{prefix}eid"]),
        num_src_nodes=int(meta[0]),
        num_dst_nodes=int(meta[1]),
        num_edges=int(meta[2]),
        reverse=reverse,
        segblocks=segb,
    )


def save_graph(path: str, g: Graph, aux: Optional[dict] = None) -> None:
    """Write a Graph (and its reverse) as one uncompressed npz, atomically
    (concurrent row subprocesses may race on the same cache file).
    ``aux``: extra named numpy arrays stored alongside (e.g. the locality
    permutation the caller needs to apply to node features)."""
    payload: dict = {}
    _pack(g, "f_", payload)
    if g.reverse is not None:
        _pack(g.reverse, "r_", payload)
    for k, v in (aux or {}).items():
        payload[f"aux_{k}"] = np.asarray(v)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_graph(path: str):
    """Returns (Graph, aux dict)."""
    z = np.load(path)
    rev = _unpack(z, "r_", None) if "r_meta" in z.files else None
    aux = {k[4:]: z[k] for k in z.files if k.startswith("aux_")}
    return _unpack(z, "f_", rev), aux


def cached_graph(
    builder: Callable[[], tuple],
    cache_dir: Optional[str],
    key: str,
):
    """``builder() -> (Graph, aux dict)`` cached at
    ``<cache_dir>/graph_<key>_<ver>.npz``; returns the same pair.

    ``key`` must encode every input that affects the build (dataset, seed,
    scale, bidirect/self-loop/reorder flags, …). A corrupt/unreadable cache
    file falls back to rebuilding and overwrites it.
    """
    if not cache_dir:
        return builder()
    safe = "".join(ch if (ch.isalnum() or ch in "._-") else "-" for ch in key)
    path = os.path.join(cache_dir, f"graph_{safe}_{_VERSION}.npz")
    if os.path.exists(path):
        try:
            return load_graph(path)
        except Exception as exc:
            print(f"[dgl_jax.graph.cache] unreadable {path}: {exc!r}; rebuilding")
    g, aux = builder()
    try:
        save_graph(path, g, aux)
    except OSError as exc:  # disk-full etc: cache is an optimization only
        print(f"[dgl_jax.graph.cache] could not write {path}: {exc!r}")
    return g, aux
