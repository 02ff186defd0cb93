"""Shared driver plumbing for the benchmark workloads.

Keeps the reference's CLI + stdout conventions (SURVEY §5 config): per-driver
argparse with benchmark defaults, ``--eval`` gating accuracy computation,
``--runs N`` re-inits, ``Training time/epoch`` line printed from the epoch
loop, Logger statistics at the end.
"""

from __future__ import annotations

import sys

import numpy as np

import jax
import jax.numpy as jnp
import optax

REPO_ROOT = __file__.rsplit("/benchmarks/", 1)[0]
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from dgl_jax.data import load_node_dataset  # noqa: E402
from dgl_jax.train import Logger  # noqa: E402


def softmax_ce_int(logits, labels):
    """CE with integer labels (optax's version trips a chex/jax-version
    incompatibility in this environment, so compute it directly)."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]


def masked_softmax_ce(logits, labels, mask):
    """Cross-entropy over masked rows (static-shape equivalent of
    ``loss_fcn(logits[train_mask], labels[train_mask])``)."""
    ce = softmax_ce_int(logits, labels)
    m = mask.astype(ce.dtype)
    return jnp.sum(ce * m) / jnp.maximum(jnp.sum(m), 1.0)


def masked_bce(logits, labels, mask):
    """Multilabel BCE-with-logits over masked rows (proteins, N8)."""
    ls = jax.nn.log_sigmoid
    per = -(labels * ls(logits) + (1.0 - labels) * ls(-logits))
    per = per.mean(axis=-1)
    m = mask.astype(per.dtype)
    return jnp.sum(per * m) / jnp.maximum(jnp.sum(m), 1.0)


def masked_accuracy(logits, labels, mask):
    pred = jnp.argmax(logits, axis=-1)
    hit = (pred == labels).astype(jnp.float32) * mask.astype(jnp.float32)
    return jnp.sum(hit) / jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)


def adam_l2(lr: float, weight_decay: float = 0.0) -> optax.GradientTransformation:
    """torch.optim.Adam semantics: L2 term added to the gradient *before*
    the adam moments (not decoupled AdamW)."""
    if weight_decay:
        return optax.chain(optax.add_decayed_weights(weight_decay), optax.adam(lr))
    return optax.adam(lr)


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Binary ROC-AUC via rank statistic (no sklearn dependency)."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel()
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    # tie-averaged ranks
    allv = np.concatenate([pos, neg])
    uniq, counts = np.unique(allv, return_counts=True)
    cum = np.cumsum(counts)
    avg_rank = (cum - (counts - 1) / 2.0).astype(np.float64)
    ranks_tied = avg_rank[np.searchsorted(uniq, allv)]
    r_pos = ranks_tied[: len(pos)].sum()
    auc = (r_pos - len(pos) * (len(pos) + 1) / 2.0) / (len(pos) * len(neg))
    return float(auc)


def mean_multilabel_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Mean per-task ROC-AUC (OGB proteins evaluator semantics)."""
    aucs = []
    for t in range(labels.shape[1]):
        a = roc_auc(scores[:, t], labels[:, t])
        if not np.isnan(a):
            aucs.append(a)
    return float(np.mean(aucs)) if aucs else float("nan")


def print_data_stats(data):
    print(
        "----Data statistics------'\n"
        f"  #Edges {len(data.src)}\n"
        f"  #Classes {data.num_classes}\n"
        f"  #Train samples {int(data.train_mask.sum())}\n"
        f"  #Val samples {int(data.val_mask.sum())}\n"
        f"  #Test samples {int(data.test_mask.sum())}"
    )
    if data.synthetic:
        print("  (synthetic fallback data — structural stats matched to the real dataset)")


def data_cache_suffix(data):
    """Disk-cache key component tying cached derived artifacts (canonical
    graph, x_agg, cluster g_full) to the *content* of the loaded dataset.

    Synthetic fallbacks are structure-matched to the real dataset's exact
    N/E (data/synthetic.py), so a key of name/scale/flags alone would let a
    real-data run silently reuse a graph cached from a synthetic run (or a
    stale real one) — shapes match, nothing errors, results are wrong.
    Synthetic data keeps the legacy empty suffix (it is
    deterministic per name/scale/seed, and prewarmed caches stay valid);
    real data gets a fingerprint over the edge list.
    """
    if getattr(data, "synthetic", True):
        return ""
    import hashlib

    src, dst = np.asarray(data.src), np.asarray(data.dst)
    h = hashlib.sha1()
    h.update(np.int64(data.num_nodes).tobytes())
    h.update(np.int64(len(src)).tobytes())
    stride = max(1, len(src) // 4096)
    h.update(np.ascontiguousarray(src[::stride]).tobytes())
    h.update(np.ascontiguousarray(dst[::stride]).tobytes())
    return "_real" + h.hexdigest()[:10]


def prepare_full_graph(
    name, data, *, scale=1.0, seed=0, bidirect=False, self_loops=False,
    reorder=False, order_key=None, cache_min_edges=4_000_000,
):
    """Shared edge pipeline for the full-graph node drivers:
    bidirect → locality reorder → self-loops → from_edges, with the whole
    result disk-cached for big graphs (dgl_jax/graph/cache.py — products-
    scale host prep is ~5 min/process and every harness row is a fresh
    subprocess). Node-indexed arrays are permuted by the cached order so a
    cache hit never recomputes the partitioner.

    Returns ``(g, features, labels, mask_arrays, order)``; ``order`` is
    None when ``reorder`` is False.
    """
    import dgl_jax
    from dgl_jax.data.loaders import data_root
    from dgl_jax.graph import transforms
    from dgl_jax.graph.cache import cached_graph

    src, dst = np.asarray(data.src), np.asarray(data.dst)
    n = data.num_nodes
    cache = data_root() if len(src) >= cache_min_edges else None
    key = (f"{name}_s{scale}_sd{seed}_b{int(bidirect)}"
           f"l{int(self_loops)}r{int(reorder)}{data_cache_suffix(data)}")

    def build():
        s, d = (transforms.to_bidirected(src, dst, n) if bidirect
                else (src, dst))
        aux = {}
        if reorder:
            from dgl_jax.graph.reorder import apply_order, locality_order

            order = locality_order(
                s, d, n, seed=seed, cache_dir=data_root(),
                cache_key=order_key or f"{name}_s{scale}")
            s, d, _ = apply_order(order, s, d)
            aux["order"] = order
        if self_loops:
            s, d = transforms.add_self_loops(s, d, n)
        # numpy leaves: the cache writes without a device round-trip
        return dgl_jax.from_edges(s, d, n, device=False), aux

    g, aux = cached_graph(build, cache, key)
    if not isinstance(g.src, jnp.ndarray) or cache is None:
        # upload numpy-leaf graphs (fresh small builds / cache-miss path)
        g = jax.tree_util.tree_map(jnp.asarray, g)
    order = aux.get("order")
    features, labels = data.features, data.labels
    masks = {k: getattr(data, f"{k}_mask") for k in ("train", "val", "test")}
    if order is not None:
        features = np.asarray(features)[order]
        labels = np.asarray(labels)[order]
        masks = {k: np.asarray(v)[order] for k, v in masks.items()}
    return g, features, labels, masks, order
