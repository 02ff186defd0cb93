"""ctypes bindings for the native host-side graph runtime.

Compiles ``graph_ops.cpp`` on first use (g++ -O3 -march=native -fopenmp)
into the package build dir and exposes NumPy-facing wrappers. The library's
file name carries a hash of the source, the flags and the host CPU, so a
library built for another machine or from other sources is never loaded.
Every entry point has a pure-NumPy fallback, selected automatically if the
toolchain or the shared object is unavailable (or if ``DGL_JAX_NO_NATIVE=1``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "graph_ops.cpp")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def host_cpu() -> str:
    """What ``-march=native`` compiles for: the CPU model and its feature
    flags (``/proc/cpuinfo``), or the platform's processor string."""
    try:
        with open("/proc/cpuinfo") as f:
            keep = {}
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and key not in keep:
                    keep[key] = line.strip()
        if keep:
            return "\n".join(keep[k] for k in sorted(keep))
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_key(source: bytes, flags, cpu: str) -> str:
    """Hash naming the library built from ``source`` with ``flags`` on ``cpu``."""
    h = hashlib.sha256(source)
    h.update("\0".join(flags).encode())
    h.update(b"\0" + cpu.encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    with open(_SRC, "rb") as f:
        key = library_key(f.read(), _FLAGS, host_cpu())
    return os.path.join(_HERE, "_build", f"libgraph_ops-{key}.so")


def _compile() -> Optional[str]:
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)  # atomic: concurrent builders never see half a file
        return path
    except Exception as exc:
        print(f"[dgl_jax.native] compile failed ({exc}); using NumPy fallbacks",
              file=sys.stderr)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("DGL_JAX_NO_NATIVE"):
            return None
        path = _compile()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.sample_neighbors.argtypes = [
            _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, _i64p,
        ]
        lib.sample_neighbors.restype = None
        lib.sample_neighbors_noreplace.argtypes = [
            _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, _i64p,
        ]
        lib.sample_neighbors_noreplace.restype = None
        lib.node_subgraph.argtypes = [
            _i64p, _i64p, ctypes.c_int64, _i64p, ctypes.c_int64,
            _i64p, _u8p, _i64p, _i64p,
        ]
        lib.node_subgraph.restype = ctypes.c_int64
        lib.partition_lp.argtypes = [
            _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_uint64, _i64p,
        ]
        lib.partition_lp.restype = None
        lib.partition_multilevel.argtypes = [
            _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, _i64p,
        ]
        lib.partition_multilevel.restype = ctypes.c_int64
        lib.build_csr.argtypes = [
            _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p,
        ]
        lib.build_csr.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def sample_neighbors(
    indptr: np.ndarray, indices: np.ndarray, seeds: np.ndarray, fanout: int, seed: int
) -> np.ndarray:
    """(len(seeds), fanout) in-neighbor samples with replacement; zero-degree
    seeds yield themselves."""
    lib = get_lib()
    seeds = np.ascontiguousarray(seeds, dtype=np.int64)
    if lib is not None:
        out = np.empty(len(seeds) * fanout, dtype=np.int64)
        lib.sample_neighbors(
            np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int64),
            seeds, len(seeds), fanout, seed & 0xFFFFFFFFFFFFFFFF, out,
        )
        return out.reshape(len(seeds), fanout)
    rng = np.random.default_rng(seed)
    deg = indptr[seeds + 1] - indptr[seeds]
    r = rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(seeds), fanout))
    picks = indices[indptr[seeds][:, None] + r]
    return np.where(deg[:, None] > 0, picks, seeds[:, None])


def sample_neighbors_noreplace(
    indptr: np.ndarray, indices: np.ndarray, seeds: np.ndarray, fanout: int, seed: int
) -> np.ndarray:
    """(len(seeds), fanout) DISTINCT in-neighbor samples (DGL's
    without-replacement semantics, reference ``ns-sage-dgl.py:132``).
    Seeds with deg < fanout keep all deg distinct neighbors, filled
    cyclically to the static slot count; zero-degree seeds yield
    themselves."""
    if fanout > 64:
        raise ValueError("noreplace fanout is capped at 64 "
                         "(Floyd scratch in graph_ops.cpp)")
    lib = get_lib()
    seeds = np.ascontiguousarray(seeds, dtype=np.int64)
    if lib is not None:
        out = np.empty(len(seeds) * fanout, dtype=np.int64)
        lib.sample_neighbors_noreplace(
            np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int64),
            seeds, len(seeds), fanout, seed & 0xFFFFFFFFFFFFFFFF, out,
        )
        return out.reshape(len(seeds), fanout)
    rng = np.random.default_rng(seed)
    out = np.empty((len(seeds), fanout), dtype=np.int64)
    for i, v in enumerate(seeds):
        lo, hi = int(indptr[v]), int(indptr[v + 1])
        deg = hi - lo
        if deg <= 0:
            out[i] = v
        elif deg <= fanout:
            out[i] = indices[lo + (np.arange(fanout) % deg)]
        else:
            out[i] = indices[lo + rng.choice(deg, size=fanout, replace=False)]
    return out


class SubgraphExtractor:
    """Reusable node-induced subgraph extraction over a by-src CSR
    (allocates the num_nodes-sized scratch once)."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, num_nodes: int):
        self.indptr = np.ascontiguousarray(indptr, np.int64)
        self.indices = np.ascontiguousarray(indices, np.int64)
        self.num_nodes = num_nodes
        self._mapping = np.zeros(num_nodes, dtype=np.int64)
        self._present = np.zeros(num_nodes, dtype=np.uint8)
        # scratch buffers are shared across calls; serialize extract() so a
        # prefetch thread and the main thread can share one extractor
        self._scratch_lock = threading.Lock()

    def extract(self, nodes: np.ndarray):
        nodes = np.ascontiguousarray(nodes, np.int64)
        lib = get_lib()
        if lib is not None:
            cap = int(self.indptr[nodes + 1].sum() - self.indptr[nodes].sum())
            out_src = np.empty(max(cap, 1), dtype=np.int64)
            out_dst = np.empty(max(cap, 1), dtype=np.int64)
            with self._scratch_lock:
                n = lib.node_subgraph(
                    self.indptr, self.indices, self.num_nodes, nodes, len(nodes),
                    self._mapping, self._present, out_src, out_dst,
                )
            return out_src[:n], out_dst[:n]
        present = np.zeros(self.num_nodes, dtype=bool)
        present[nodes] = True
        spans = [np.arange(self.indptr[v], self.indptr[v + 1]) for v in nodes]
        rel_src = np.concatenate(
            [np.full(len(s), i) for i, s in enumerate(spans)]
        ) if spans else np.zeros(0, np.int64)
        cand = np.concatenate(spans) if spans else np.zeros(0, np.int64)
        keep = present[self.indices[cand]]
        mapping = np.zeros(self.num_nodes, dtype=np.int64)
        mapping[nodes] = np.arange(len(nodes))
        return rel_src[keep].astype(np.int64), mapping[self.indices[cand[keep]]]


def partition_multilevel(
    src: np.ndarray, dst: np.ndarray, num_nodes: int, k: int, seed: int
) -> Optional[np.ndarray]:
    """Native multilevel k-way partition (heavy-edge matching coarsening +
    BFS growing + boundary refinement — the METIS recipe). None → no native
    lib; caller should fall back to LP."""
    lib = get_lib()
    if lib is None:
        return None
    part = np.empty(num_nodes, dtype=np.int64)
    lib.partition_multilevel(
        np.ascontiguousarray(src, np.int64), np.ascontiguousarray(dst, np.int64),
        len(src), num_nodes, k, seed & 0xFFFFFFFFFFFFFFFF, part,
    )
    return part


def partition_lp(
    src: np.ndarray, dst: np.ndarray, num_nodes: int, k: int, rounds: int, seed: int
) -> Optional[np.ndarray]:
    """Native label-propagation partition; None → caller uses NumPy path."""
    lib = get_lib()
    if lib is None:
        return None
    part = np.empty(num_nodes, dtype=np.int64)
    lib.partition_lp(
        np.ascontiguousarray(src, np.int64), np.ascontiguousarray(dst, np.int64),
        len(src), num_nodes, k, rounds, seed & 0xFFFFFFFFFFFFFFFF, part,
    )
    return part


def build_csr(key: np.ndarray, val: np.ndarray, num_nodes: int):
    """Counting-sort CSR build: returns (indptr, sorted_val, eid_perm) —
    the native core of Graph.from_edges (replaces np.argsort, O(E) not
    O(E log E))."""
    lib = get_lib()
    key = np.ascontiguousarray(key, np.int64)
    val = np.ascontiguousarray(val, np.int64)
    if lib is not None:
        indptr = np.empty(num_nodes + 1, dtype=np.int64)
        out_val = np.empty(len(val), dtype=np.int64)
        out_eid = np.empty(len(val), dtype=np.int64)
        lib.build_csr(key, val, len(key), num_nodes, indptr, out_val, out_eid)
        return indptr, out_val, out_eid
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, val[order], order
