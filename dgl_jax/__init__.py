"""dgl_jax — a graph neural network framework on JAX.

Built from scratch on JAX/XLA to cover the full capability surface of the
``dglai/dgl-0.5-benchmark`` suite (see SURVEY.md): an immutable
static-shape graph tensor, fused message-passing ops (SpMM / SDDMM /
edge-softmax), a functional NN layer zoo (SAGE, GAT, GCN, RGCN, GCMC),
sampling + partitioning pipelines, and mesh-sharded multi-device execution.
"""

__version__ = "0.1.0"

import os as _os
from typing import Mapping as _Mapping, Optional as _Optional

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ: _Mapping[str, str] = _os.environ) -> _Optional[str]:
    """Where the program keeps XLA's persistent compilation cache: nowhere of
    its own when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads that
    itself), else the fixed directory ``.jax_cache`` of the checkout."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(_REPO_ROOT, ".jax_cache")


def _configure_compile_cache() -> None:
    import jax

    d = compile_cache_dir()
    if d is not None:
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_configure_compile_cache()

from .graph import (
    Graph,
    GraphBatch,
    HeteroGraph,
    batch_graphs,
    from_edges,
    from_scipy_coo,
    readout,
)
from . import ops
from . import graph

__all__ = [
    "Graph",
    "GraphBatch",
    "HeteroGraph",
    "batch_graphs",
    "from_edges",
    "from_scipy_coo",
    "readout",
    "ops",
    "graph",
    "compile_cache_dir",
]
