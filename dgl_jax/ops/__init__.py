"""Functional message-passing ops (the framework's kernel API).

These are the equivalents of the native DGL/PyG kernel surface
the reference suite bottoms out in (SURVEY §2.3): g-SpMM, g-SDDMM,
edge-softmax, segment reductions and graph readout. All are pure functions
of (Graph, arrays) and are differentiable; hot paths carry custom VJPs that
keep backward scatters sorted.
"""

from .segment import (
    segment_sum,
    segment_mean,
    segment_max,
    segment_min,
    segment_count,
)
from .spmm import gspmm, gspmm_chunked, copy_u_sum, copy_u_mean, u_mul_e_sum
from .sddmm import gsddmm, u_dot_v, u_mul_v
from .softmax import edge_softmax
from .gather import gather_dst, gather_src

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_count",
    "gspmm",
    "gspmm_chunked",
    "copy_u_sum",
    "copy_u_mean",
    "u_mul_e_sum",
    "gsddmm",
    "u_dot_v",
    "u_mul_v",
    "edge_softmax",
    "gather_dst",
    "gather_src",
]
