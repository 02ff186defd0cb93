"""Heterogeneous graphs: typed node sets + typed bipartite relations.

Equivalent of the DGL heterograph engine that GCMC exercises
(``dgl.bipartite`` / ``hetero_from_relations`` ``gcmc_dgl/data.py:257-263``,
``HeteroGraphConv`` ``gcmc_dgl/model.py:205``).

Design: a heterograph is just a dict of :class:`Graph` relations keyed by
canonical edge type ``(src_type, relation_name, dst_type)`` plus per-type
node counts. Per-relation convolutions run as a Python loop over relations
(unrolled into one XLA program — relation count is small and static, e.g.
2×|ratings| for GCMC), with cross-relation combination (stack/sum) done by
the caller or by ``dgl_jax.nn.HeteroGraphConv``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import jax

from .graph import Graph

EType = Tuple[str, str, str]

__all__ = ["HeteroGraph", "EType"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class HeteroGraph:
    """relations: {(src_type, rel, dst_type): Graph};
    num_nodes: {node_type: count} (static)."""

    relations: Dict[EType, Graph]
    num_nodes: Mapping[str, int]

    def tree_flatten(self):
        keys = tuple(sorted(self.relations.keys()))
        leaves = tuple(self.relations[k] for k in keys)
        aux = (keys, tuple(sorted(self.num_nodes.items())))
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        keys, nn = aux
        return cls(dict(zip(keys, leaves)), dict(nn))

    def __getitem__(self, etype: EType) -> Graph:
        return self.relations[etype]

    @property
    def etypes(self):
        return sorted(self.relations.keys())

    def node_types(self):
        return sorted(self.num_nodes.keys())

    def validate(self):
        for (st, _, dt), g in self.relations.items():
            assert g.num_src_nodes == self.num_nodes[st], (st, g)
            assert g.num_dst_nodes == self.num_nodes[dt], (dt, g)
        return self
