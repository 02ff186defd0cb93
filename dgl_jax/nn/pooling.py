"""Graph readout modules (API parity with ``dgl.nn.AvgPooling`` etc.,
``main_dgl_enzymes_gcn.py:62``). Thin module wrappers over the functional
``dgl_jax.graph.batch.readout``."""

from __future__ import annotations

from . import linen as nn

from ..graph.batch import GraphBatch, readout

__all__ = ["AvgPooling", "SumPooling", "MaxPooling"]


class AvgPooling(nn.Module):
    @nn.compact
    def __call__(self, batch: GraphBatch, x):
        return readout(batch, x, "mean")


class SumPooling(nn.Module):
    @nn.compact
    def __call__(self, batch: GraphBatch, x):
        return readout(batch, x, "sum")


class MaxPooling(nn.Module):
    @nn.compact
    def __call__(self, batch: GraphBatch, x):
        return readout(batch, x, "max")
