"""Cluster-batched link prediction (reference S7:
``sampling/link-prediction/cluster_gcn_dgl.py`` + ``dgl_cluster_sampler.py``).

Semantics preserved: GCN/SAGE/GAT encoder over cluster subgraphs
(``cluster_gcn_dgl.py:19-48``), per-batch uniform negative-edge graph built
in the collate (``dgl_cluster_sampler.py:97-109``), loss =
``-logsigmoid(pos) - logsigmoid(-neg)`` with dot-product edge scores
(``:91-102,131-144``), MLP link predictor for ranking eval (``:64-88``),
full-graph encode for evaluation (``:164-209``) with MRR against K uniform
negatives per positive (ogbl-citation2 evaluator protocol).

The reference file as shipped is a 1-epoch profiler with a hard ``exit(0)``
and an undefined-variable eval path (``cluster_gcn_dgl.py:160,292`` — SURVEY
§2.1 S7); this driver implements the full intended loop.
"""

import argparse
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, __file__.rsplit("/benchmarks/", 1)[0] + "/benchmarks")
from common import load_node_dataset, print_data_stats  # noqa: E402

import dgl_jax  # noqa: E402
from dgl_jax.data.loaders import data_root  # noqa: E402
from dgl_jax.models import GraphSAGE  # noqa: E402
from dgl_jax.nn import PairMLPPredictor  # noqa: E402
from dgl_jax.ops import u_dot_v  # noqa: E402
from dgl_jax.sampling.cluster import ClusterIter  # noqa: E402
from dgl_jax.train import Logger  # noqa: E402


def main():
    p = argparse.ArgumentParser(description="Cluster link prediction (dgl_jax)")
    p.add_argument("--dataset", type=str, default="ogbn-arxiv",
                   help="any node dataset; 5%% of edges held out as val/test links")
    p.add_argument("--n-epochs", type=int, default=10)
    p.add_argument("--n-hidden", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=3)
    p.add_argument("--psize", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--dropout", type=float, default=0.3)
    p.add_argument("--num-negs", type=int, default=1000, help="negatives per eval positive")
    p.add_argument("--predictor", type=str, default="dot", choices=["dot", "mlp"])
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--part-method", type=str, default="metis",
                   choices=["metis", "lp", "random"])
    args = p.parse_args()
    print(args)

    data = load_node_dataset(args.dataset, seed=args.seed, scale=args.scale)
    print_data_stats(data)
    rng = np.random.default_rng(args.seed)

    # hold out edges as link-prediction targets (train graph loses them)
    n_e = len(data.src)
    perm = rng.permutation(n_e)
    n_val = n_test = max(1, int(0.025 * n_e))
    val_e = perm[:n_val]
    test_e = perm[n_val : n_val + n_test]
    train_e = perm[n_val + n_test :]
    src_tr, dst_tr = data.src[train_e], data.dst[train_e]

    cluster_iter = ClusterIter(
        f"{args.dataset}_lp_s{args.scale}", src_tr, dst_tr, data.num_nodes,
        data.features, data.labels.reshape(len(data.labels), -1)[:, :1],
        np.ones(data.num_nodes, bool),
        args.psize, args.batch_size, method=args.part_method,
        seed=args.seed, cache_dir=data_root(),
        with_negatives=True,
    )
    g_full = dgl_jax.from_edges(src_tr, dst_tr, data.num_nodes)
    x_full = jnp.asarray(data.features)

    model = GraphSAGE(
        hidden_feats=args.n_hidden, out_feats=args.n_hidden,
        num_layers=args.n_layers, dropout=args.dropout,
    )
    predictor = PairMLPPredictor(hidden=args.n_hidden) if args.predictor == "mlp" else None
    tx = optax.adam(args.lr)

    def score_pairs(pred_params, h_i, h_j):
        if predictor is None:
            return jnp.sum(h_i * h_j, axis=-1)
        return predictor.apply(pred_params, h_i, h_j)

    @jax.jit
    def train_step(params, pred_params, opt, key, g, neg_g, x):
        def loss_fn(pp, qq):
            h = model.apply({"params": pp}, g, x, deterministic=False, rngs={"dropout": key})
            if predictor is None:
                pos = u_dot_v(g, h, h)[:, 0]
                neg = u_dot_v(neg_g, h, h)[:, 0]
            else:
                def pair_scores(gg):
                    hi = jnp.take(h, jnp.minimum(gg.src, gg.num_src_nodes - 1), axis=0)
                    hj = jnp.take(h, jnp.minimum(gg.dst, gg.num_dst_nodes - 1), axis=0)
                    return predictor.apply(qq, hi, hj)
                pos = pair_scores(g)
                neg = pair_scores(neg_g)
            m = g.edge_mask()
            ls = jax.nn.log_sigmoid
            loss = -(ls(pos) * m).sum() / jnp.maximum(m.sum(), 1.0)
            loss = loss - (ls(-neg) * m).sum() / jnp.maximum(m.sum(), 1.0)
            return loss
        if predictor is None:
            loss, grads = jax.value_and_grad(loss_fn)(params, None)
            updates, opt = tx.update(grads, opt, params)
            return optax.apply_updates(params, updates), pred_params, opt, loss
        loss, (g1, g2) = jax.value_and_grad(loss_fn, argnums=(0, 1))(params, pred_params)
        updates, opt = tx.update((g1, g2), opt, (params, pred_params))
        params, pred_params = optax.apply_updates((params, pred_params), updates)
        return params, pred_params, opt, loss

    @jax.jit
    def encode_full(params, g, x):
        return model.apply({"params": params}, g, x, deterministic=True)

    def mrr(h, pred_params, eids):
        """Filtered-MRR against ``num_negs`` uniform negatives per positive
        (ogbl-citation2 evaluator protocol), one batched device call."""
        s, d = data.src[eids], data.dst[eids]
        hs = jnp.take(h, jnp.asarray(s), axis=0)
        pos = np.asarray(score_pairs(pred_params, hs, jnp.take(h, jnp.asarray(d), axis=0)))
        neg_d = rng.integers(0, data.num_nodes, size=(len(eids), args.num_negs))
        hneg = jnp.take(h, jnp.asarray(neg_d.reshape(-1)), axis=0).reshape(
            len(eids), args.num_negs, -1)
        neg = np.asarray(score_pairs(pred_params, hs[:, None, :], hneg))
        ranks = 1.0 / (1 + (neg >= pos[:, None]).sum(axis=1))
        return float(ranks.mean())

    logger = Logger(args.runs, scale=1.0)
    for run in range(args.runs):
        key = jax.random.PRNGKey(args.seed * 1000 + run)
        first = cluster_iter.first()
        params = jax.jit(model.init)(key, first.graph, first.x)["params"]
        pred_params = (
            predictor.init(key, jnp.zeros((4, args.n_hidden)), jnp.zeros((4, args.n_hidden)))
            if predictor is not None else None
        )
        opt = tx.init(params if predictor is None else (params, pred_params))
        dur = []
        for epoch in range(args.n_epochs):
            t0 = time.time()
            for batch in cluster_iter:
                key, sub = jax.random.split(key)
                params, pred_params, opt, loss = train_step(
                    params, pred_params, opt, sub, batch.graph, batch.neg_graph, batch.x
                )
            loss = float(loss)
            if epoch >= 3:
                dur.append(time.time() - t0)
                print("Training time/epoch {}".format(np.mean(dur)))
            if args.eval:
                h = encode_full(params, g_full, x_full)
                k = min(200, len(val_e))
                train_mrr = mrr(h, pred_params, rng.choice(train_e, size=k, replace=False))
                val_mrr = mrr(h, pred_params, val_e[:k])
                test_mrr = mrr(h, pred_params, test_e[: min(200, len(test_e))])
                logger.add_result(run, (train_mrr, val_mrr, test_mrr))
                print(f"Run: {run + 1:02d}, Epoch: {epoch:02d}, Loss: {loss:.4f}, "
                      f"Train MRR: {train_mrr:.4f} Valid MRR: {val_mrr:.4f} "
                      f"Test MRR: {test_mrr:.4f}")
        if args.eval:
            logger.print_statistics(run)
    if args.eval:
        logger.print_statistics()


if __name__ == "__main__":
    main()
