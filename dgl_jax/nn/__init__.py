"""NN layer zoo (modules of the in-repo linen layer over the dgl_jax kernel API).

Covers SURVEY §2.4: GraphSAGE, GAT, GCN (± edge features), RGCN, GCMC
(hetero encoder + bilinear decoders), link predictors, mol encoders, and
padding-aware BatchNorm.
"""

from .conv import SAGEConv, GATConv, GCNConv, GCNConvEdge, RelGraphConv
from .hetero import HeteroGraphConv
from .gcmc import GCMCGraphConv, GCMCLayer, BiDecoder, DenseBiDecoder
from .encoders import AtomEncoder, BondEncoder, CategoricalEncoder
from .predictors import DotPredictor, MLPPredictor, PairMLPPredictor
from .norm import MaskedBatchNorm
from .pooling import AvgPooling, SumPooling, MaxPooling
from .init import xavier_uniform, relu_gain, kaiming_uniform_fan_in

__all__ = [
    "SAGEConv",
    "GATConv",
    "GCNConv",
    "GCNConvEdge",
    "RelGraphConv",
    "HeteroGraphConv",
    "GCMCGraphConv",
    "GCMCLayer",
    "BiDecoder",
    "DenseBiDecoder",
    "AtomEncoder",
    "BondEncoder",
    "CategoricalEncoder",
    "DotPredictor",
    "MLPPredictor",
    "PairMLPPredictor",
    "MaskedBatchNorm",
    "AvgPooling",
    "SumPooling",
    "MaxPooling",
    "xavier_uniform",
    "relu_gain",
    "kaiming_uniform_fan_in",
]
