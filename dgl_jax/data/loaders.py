"""Real-dataset loaders (activate when files are on disk).

The reference gets data via ``dgl.data.load_data`` / OGB loaders
(``main_dgl_citation_sage.py:153``, ``main_dgl_arxiv_sage.py``); this module
reads the same public on-disk formats *independently* (no dgl/ogb deps):

* Planetoid pickles (cora/pubmed): ``ind.<name>.{x,tx,allx,y,ty,ally,graph,test.index}``
* DGL Reddit: ``reddit_data.npz`` + ``reddit_graph.npz``
* OGB node-prop: ``<root>/<name>/raw/edge.csv.gz`` + ``node-feat.csv.gz`` …
* canonical npz: ``<root>/<name>.npz`` with keys
  src, dst, x, y, train, val, test (our own cache/interchange format)

Search order per dataset: canonical npz → public raw format → synthetic
fallback (``synthetic.py``). Data root: ``$DGL_JAX_DATA_DIR`` or
``<repo>/.data_cache``.
"""

from __future__ import annotations

import gzip
import os
import pickle
import sys
from typing import Optional

import numpy as np

from .synthetic import (
    NODE_DATASET_STATS,
    GraphClassificationData,
    NodeClassificationData,
    synthetic_graph_classification,
    synthetic_node_classification,
)

__all__ = ["data_root", "load_node_dataset", "load_graph_dataset"]


def data_root() -> str:
    return os.environ.get(
        "DGL_JAX_DATA_DIR",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), ".data_cache"),
    )


def _load_canonical_npz(path: str, name: str) -> NodeClassificationData:
    z = np.load(path)
    return NodeClassificationData(
        name=name,
        src=z["src"],
        dst=z["dst"],
        num_nodes=int(z["x"].shape[0]),
        features=z["x"],
        labels=z["y"],
        train_mask=z["train"],
        val_mask=z["val"],
        test_mask=z["test"],
        num_classes=int(z["y"].max()) + 1 if z["y"].ndim == 1 else z["y"].shape[1],
        edge_feat=z["ef"] if "ef" in z.files else None,
        synthetic=False,
    )


def _parse_planetoid(root: str, name: str) -> NodeClassificationData:
    def rd(suffix):
        with open(os.path.join(root, f"ind.{name}.{suffix}"), "rb") as f:
            if suffix == "test.index":
                return np.array([int(l) for l in f.read().split()])
            return pickle.load(f, encoding="latin1")

    x, tx, allx = rd("x"), rd("tx"), rd("allx")
    y, ty, ally = rd("y"), rd("ty"), rd("ally")
    graph = rd("graph")
    test_idx = rd("test.index")

    import scipy.sparse as sp

    features = sp.vstack((allx, tx)).tolil()
    test_sorted = np.sort(test_idx)
    features[test_idx, :] = features[test_sorted, :]
    labels_oh = np.vstack((ally, ty))
    labels_oh[test_idx, :] = labels_oh[test_sorted, :]
    labels = labels_oh.argmax(axis=1)

    n = features.shape[0]
    src = np.concatenate([[u] * len(vs) for u, vs in graph.items()]).astype(np.int64)
    dst = np.concatenate([list(vs) for vs in graph.values()]).astype(np.int64)
    keep = (src < n) & (dst < n)
    src, dst = src[keep], dst[keep]

    train_mask = np.zeros(n, bool)
    train_mask[: len(y)] = True
    val_mask = np.zeros(n, bool)
    val_mask[len(y) : len(y) + 500] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_sorted] = True
    return NodeClassificationData(
        name, src, dst, n, np.asarray(features.todense(), dtype=np.float32),
        labels.astype(np.int64), train_mask, val_mask, test_mask,
        int(labels.max()) + 1, None, synthetic=False,
    )


def _parse_reddit(root: str) -> NodeClassificationData:
    import scipy.sparse as sp

    data = np.load(os.path.join(root, "reddit_data.npz"))
    g = sp.load_npz(os.path.join(root, "reddit_graph.npz")).tocoo()
    labels = data["label"].astype(np.int64)
    types = data["node_types"]
    return NodeClassificationData(
        "reddit", g.col.astype(np.int64), g.row.astype(np.int64), g.shape[0],
        data["feature"].astype(np.float32), labels,
        types == 1, types == 2, types == 3,
        int(labels.max()) + 1, None, synthetic=False,
    )


def _parse_ogb_node(root: str, name: str) -> NodeClassificationData:
    """OGB raw csv.gz layout under <root>/<name_with_underscores>/."""
    d = os.path.join(root, name.replace("-", "_"))
    raw = os.path.join(d, "raw")

    def rd_csv(fn, dtype):
        with gzip.open(os.path.join(raw, fn), "rt") as f:
            return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)

    edges = rd_csv("edge.csv.gz", np.int64)
    x = rd_csv("node-feat.csv.gz", np.float32)
    y = rd_csv("node-label.csv.gz", np.int64)[:, 0]
    split_dir = os.path.join(d, "split")
    # ogb split dirs vary by dataset (time/sales_ranking/species)
    sub = os.listdir(split_dir)[0]

    def rd_split(fn):
        with gzip.open(os.path.join(split_dir, sub, fn), "rt") as f:
            return np.loadtxt(f, dtype=np.int64, ndmin=1)

    n = x.shape[0]
    masks = {}
    for part in ("train", "valid", "test"):
        m = np.zeros(n, bool)
        m[rd_split(f"{part}.csv.gz")] = True
        masks[part] = m
    return NodeClassificationData(
        name, edges[:, 0], edges[:, 1], n, x, y,
        masks["train"], masks["valid"], masks["test"],
        int(y.max()) + 1, None, synthetic=False,
    )


def load_node_dataset(
    name: str, root: Optional[str] = None, seed: int = 0, scale: float = 1.0
) -> NodeClassificationData:
    """Load by search order: canonical npz → public raw → synthetic.

    ``scale`` (< 1) is honored only by the synthetic fallback — real data is
    never subsampled silently.
    """
    root = root or data_root()
    npz = os.path.join(root, f"{name}.npz")
    if os.path.exists(npz):
        return _load_canonical_npz(npz, name)
    try:
        if name in ("cora", "pubmed") and os.path.exists(
            os.path.join(root, name, f"ind.{name}.x")
        ):
            return _parse_planetoid(os.path.join(root, name), name)
        if name == "reddit" and os.path.exists(os.path.join(root, "reddit", "reddit_data.npz")):
            return _parse_reddit(os.path.join(root, "reddit"))
        if name.startswith("ogbn-") and os.path.isdir(
            os.path.join(root, name.replace("-", "_"), "raw")
        ):
            return _parse_ogb_node(root, name)
    except Exception as exc:  # fall back, but tell the user
        print(f"[dgl_jax.data] failed to parse on-disk {name}: {exc!r}; "
              "falling back to synthetic", file=sys.stderr)
    # DGL_JAX_SYNTH_STRUCTURAL=1 switches the synthetic fallback to the
    # structure-required construction (features alone ≈ chance) — the
    # hardened e2e gates run drivers under this env
    return synthetic_node_classification(
        name, seed=seed, cache_dir=root, scale=scale,
        structure_required=bool(os.environ.get("DGL_JAX_SYNTH_STRUCTURAL")),
    )


# -- graph classification -----------------------------------------------------
#
# Canonical interchange: ``<root>/<name>_graphs.npz`` with concatenated
# per-graph arrays (produced by ``tools/convert_dataset.py``):
#   src, dst            (sum_E,) int — graph-LOCAL node ids
#   edge_offsets        (G+1,) int — edges of graph i at [off[i], off[i+1])
#   num_nodes           (G,) int
#   node_feat           (sum_N, F) float32/int32;  node_offsets (G+1,)
#   edge_feat           optional (sum_E, Fe)
#   labels              (G,) int64
#   split_train/valid/test  optional graph-index arrays (OGB scaffold/species)


def _load_canonical_graphs_npz(path: str, name: str) -> GraphClassificationData:
    z = np.load(path)
    eo, no = z["edge_offsets"], z["node_offsets"]
    nn = z["num_nodes"]
    has_ef = "edge_feat" in z.files
    graphs, node_feats, edge_feats = [], [], []
    for i in range(len(nn)):
        graphs.append((z["src"][eo[i]:eo[i + 1]].astype(np.int64),
                       z["dst"][eo[i]:eo[i + 1]].astype(np.int64), int(nn[i])))
        node_feats.append(z["node_feat"][no[i]:no[i + 1]])
        edge_feats.append(z["edge_feat"][eo[i]:eo[i + 1]] if has_ef else None)
    labels = z["labels"].astype(np.int64)
    splits = None
    if "split_train" in z.files:
        splits = {k: z[f"split_{k}"].astype(np.int64)
                  for k in ("train", "valid", "test")}
    return GraphClassificationData(
        name, graphs, node_feats, edge_feats, labels,
        int(labels.max()) + 1, synthetic=False, splits=splits,
    )


def _parse_tu(root: str, name: str) -> GraphClassificationData:
    """TUDataset raw text format (reference: ``LegacyTUDataset`` in
    ``main_dgl_enzymes_gcn.py:155``): 1-based global node ids in
    ``<name>_A.txt``, per-node graph membership, per-graph labels,
    continuous node attributes (ENZYMES: 18 dims)."""
    def rd(suffix, dtype=np.int64, delim=","):
        return np.loadtxt(os.path.join(root, f"{name}_{suffix}.txt"),
                          dtype=dtype, delimiter=delim, ndmin=1)

    edges = rd("A", np.int64) - 1  # (sum_E, 2), to 0-based
    gi = rd("graph_indicator") - 1  # (sum_N,) graph id per node
    raw_labels = rd("graph_labels")
    # TU labels may be 1-based or arbitrary ints; compact to 0..C-1
    _, labels = np.unique(raw_labels, return_inverse=True)
    try:
        nf_all = rd("node_attributes", np.float32).reshape(len(gi), -1)
    except OSError:
        # fall back to one-hot node labels when no continuous attributes
        nl = rd("node_labels")
        nl = nl - nl.min()
        nf_all = np.eye(int(nl.max()) + 1, dtype=np.float32)[nl]
    num_graphs = int(gi.max()) + 1
    node_counts = np.bincount(gi, minlength=num_graphs)
    node_off = np.concatenate([[0], np.cumsum(node_counts)])
    # edges belong to the graph of their source node; ids become graph-local
    eg = gi[edges[:, 0]]
    order = np.argsort(eg, kind="stable")
    edges, eg = edges[order], eg[order]
    edge_counts = np.bincount(eg, minlength=num_graphs)
    edge_off = np.concatenate([[0], np.cumsum(edge_counts)])
    graphs, node_feats = [], []
    for i in range(num_graphs):
        e = edges[edge_off[i]:edge_off[i + 1]] - node_off[i]
        graphs.append((e[:, 0], e[:, 1], int(node_counts[i])))
        node_feats.append(nf_all[node_off[i]:node_off[i + 1]])
    return GraphClassificationData(
        name, graphs, node_feats, [None] * num_graphs,
        labels.astype(np.int64), int(labels.max()) + 1, synthetic=False,
    )


def _parse_ogb_graphs(root: str, name: str) -> GraphClassificationData:
    """OGB graph-prop raw csv.gz layout under ``<root>/<name_with_underscores>/``."""
    d = os.path.join(root, name.replace("-", "_"))
    raw = os.path.join(d, "raw")

    def rd_csv(fn, dtype):
        with gzip.open(os.path.join(raw, fn), "rt") as f:
            return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)

    edges = rd_csv("edge.csv.gz", np.int64)  # graph-local ids
    num_nodes = rd_csv("num-node-list.csv.gz", np.int64)[:, 0]
    num_edges = rd_csv("num-edge-list.csv.gz", np.int64)[:, 0]
    labels = rd_csv("graph-label.csv.gz", np.int64)[:, 0]
    nf_path = os.path.join(raw, "node-feat.csv.gz")
    if os.path.exists(nf_path):
        nf_all = rd_csv("node-feat.csv.gz",
                        np.int64 if name == "ogbg-molhiv" else np.float32)
    else:
        # ogbg-ppa ships NO node features in the OGB raw layout (its node
        # encoder is a single shared embedding over a constant id); feed the
        # conventional all-zeros one-column feature, matching the synthetic
        # twin (data/synthetic.py "ppa" branch) and OGB's own examples
        nf_all = np.zeros((int(num_nodes.sum()), 1), np.int64)
    ef_path = os.path.join(raw, "edge-feat.csv.gz")
    ef_all = None
    if os.path.exists(ef_path):
        ef_all = rd_csv("edge-feat.csv.gz",
                        np.int64 if name == "ogbg-molhiv" else np.float32)
    node_off = np.concatenate([[0], np.cumsum(num_nodes)])
    edge_off = np.concatenate([[0], np.cumsum(num_edges)])
    graphs, node_feats, edge_feats = [], [], []
    for i in range(len(num_nodes)):
        e = edges[edge_off[i]:edge_off[i + 1]]
        graphs.append((e[:, 0], e[:, 1], int(num_nodes[i])))
        node_feats.append(nf_all[node_off[i]:node_off[i + 1]].astype(
            np.int32 if nf_all.dtype == np.int64 else np.float32))
        edge_feats.append(
            None if ef_all is None
            else ef_all[edge_off[i]:edge_off[i + 1]].astype(
                np.int32 if ef_all.dtype == np.int64 else np.float32))
    split_dir = os.path.join(d, "split")
    splits = None
    if os.path.isdir(split_dir):
        sub = sorted(os.listdir(split_dir))[0]

        def rd_split(fn):
            with gzip.open(os.path.join(split_dir, sub, fn), "rt") as f:
                return np.loadtxt(f, dtype=np.int64, ndmin=1)

        splits = {k: rd_split(f"{k}.csv.gz") for k in ("train", "valid", "test")}
    return GraphClassificationData(
        name, graphs, node_feats, edge_feats, labels,
        int(labels.max()) + 1, synthetic=False, splits=splits,
    )


def load_graph_dataset(
    name: str, root: Optional[str] = None, seed: int = 0,
    num_graphs: Optional[int] = None,
) -> GraphClassificationData:
    """Graph-classification datasets (ENZYMES/ogbg-molhiv/ogbg-ppa), search
    order: canonical npz → public raw (TU text / OGB csv.gz) → synthetic.

    ``num_graphs`` caps the dataset size; real data is truncated (with a
    notice) only when a cap is explicitly requested.
    """
    root = root or data_root()
    data = None
    npz = os.path.join(root, f"{name}_graphs.npz")
    try:
        if os.path.exists(npz):
            data = _load_canonical_graphs_npz(npz, name)
        elif os.path.exists(os.path.join(root, name, f"{name}_A.txt")):
            data = _parse_tu(os.path.join(root, name), name)
        elif name.startswith("ogbg-") and os.path.isdir(
            os.path.join(root, name.replace("-", "_"), "raw")
        ):
            data = _parse_ogb_graphs(root, name)
    except Exception as exc:
        print(f"[dgl_jax.data] failed to parse on-disk {name}: {exc!r}; "
              "falling back to synthetic", file=sys.stderr)
    if data is None:
        return synthetic_graph_classification(name, seed=seed, num_graphs=num_graphs)
    if num_graphs is not None and num_graphs < len(data.graphs):
        print(f"[dgl_jax.data] {name}: capping {len(data.graphs)} -> "
              f"{num_graphs} graphs (--num-graphs)", file=sys.stderr)
        keep = np.arange(num_graphs)
        splits = None
        if data.splits is not None:
            splits = {k: v[v < num_graphs] for k, v in data.splits.items()}
        data = GraphClassificationData(
            name, [data.graphs[i] for i in keep],
            [data.node_feats[i] for i in keep],
            [data.edge_feats[i] for i in keep],
            data.labels[keep], data.num_classes,
            synthetic=False, splits=splits,
        )
    return data
