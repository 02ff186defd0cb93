"""Graph classification: ENZYMES GCN (reference G1,
``main_dgl_enzymes_gcn.py``) and OGB mol datasets (G2/G3,
``main_dgl_molhiv_gcn.py`` / ``main_dgl_ppa_gcn.py``) in one driver.

Reference conventions preserved: 80/10/10 split with numpy seed 42
(``main_dgl_enzymes_gcn.py:155-163``), batch-size axis {64,128,256}
(README.md:51-67), nll loss on log_softmax (ENZYMES), BCE (molhiv ROC-AUC) /
CE (ppa), ``Training time/epoch`` from epoch 3.

Static-shape batching: every batch is padded to one global bucket shape so a
single compiled step serves the epoch; collation runs on host threads
(``dgl_jax.sampling.GraphBatchLoader``).
"""

import argparse
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, __file__.rsplit("/benchmarks/", 1)[0] + "/benchmarks")
from common import (  # noqa: E402
    masked_softmax_ce,
    softmax_ce_int,
    roc_auc,
    print_data_stats,
    Logger,
)

from dgl_jax.data import load_graph_dataset  # noqa: E402
from dgl_jax.models import GCNGraphClassifier, GCNMolClassifier  # noqa: E402
from dgl_jax.sampling.dataloader import GraphBatchLoader  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Graph classification GCN (dgl_jax)")
    parser.add_argument("--dataset", type=str, default="ENZYMES",
                        choices=["ENZYMES", "ogbg-molhiv", "ogbg-ppa"])
    parser.add_argument("--device", type=int, default=0)
    parser.add_argument("--log_steps", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_layers", type=int, default=None)
    parser.add_argument("--hidden_size", type=int, default=None)
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--eval", action="store_true",
                        help="If not set, we will only do the training part.")
    parser.add_argument("--eval_batch_size", type=int, default=2048)
    parser.add_argument("--lowering", choices=("fused", "scatter"),
                        default="fused",
                        help="message-passing lowering: 'fused' = custom-VJP "
                             "sorted reductions (DGL-style); 'scatter' = "
                             "explicit gather + plain segment op with AD "
                             "scatter-add (PyG-style; reproduces the "
                             "reference's molhiv fused-vs-scatter comparison, "
                             "README.md:72)")
    parser.add_argument("--num-graphs", type=int, default=None,
                        help="subsample the dataset (synthetic scale knob)")
    parser.add_argument("--scan-steps", action="store_true",
                        help="after epoch 1 builds the device-resident batch "
                             "cache, run each further epoch's train steps in "
                             "ONE lax.scan dispatch (batch gathered on-device "
                             "by traced index). Removes the per-step dispatch "
                             "latency (x514 steps on molhiv). Same math: identical "
                             "steps, sequential optimizer updates, "
                             "order-shuffled like the cache path.")
    args = parser.parse_args()
    is_mol = args.dataset != "ENZYMES"
    if args.num_layers is None:
        args.num_layers = 5 if is_mol else 4
    if args.hidden_size is None:
        args.hidden_size = 256 if is_mol else 128
    if args.dataset == "ogbg-ppa" and args.eval_batch_size == 2048:
        # ppa graphs average ~243 nodes: a 2048-graph padded eval batch plus
        # the device-resident train cache ran out of device memory
        # mid-eval; 512 keeps the eval spike a quarter of that.
        args.eval_batch_size = 512
    print(args)
    if args.lowering == "scatter":
        os.environ["DGL_JAX_LOWERING"] = "scatter"

    data = load_graph_dataset(args.dataset, num_graphs=args.num_graphs)
    if data.synthetic:
        print("  (synthetic fallback data — structural stats matched to the real dataset)")
    n = len(data.graphs)
    if data.splits is not None:
        # real OGB scaffold/species split shipped with the dataset
        tr, va, te = data.splits["train"], data.splits["valid"], data.splits["test"]
    else:
        # reference split: random 80/10/10, seed 42 (main_dgl_enzymes_gcn.py:155-163)
        indices = np.arange(n)
        np.random.seed(42)
        np.random.shuffle(indices)
        tr, va = indices[: int(n * 0.8)], indices[int(n * 0.8): int(n * 0.9)]
        te = indices[int(n * 0.9):]

    def subset(idx):
        return (
            [data.graphs[i] for i in idx],
            [data.node_feats[i] for i in idx],
            [data.edge_feats[i] for i in idx],
            data.labels[idx],
        )

    def loader(idx, bs, shuffle, seed=0):
        gs, nf, ef, y = subset(idx)
        return GraphBatchLoader(
            gs, nf, y, bs, edge_feats=ef if is_mol else None, shuffle=shuffle, seed=seed
        )

    train_loader = loader(tr, args.batch_size, True)
    train_eval_loader = loader(tr, args.eval_batch_size, False)
    val_loader = loader(va, args.eval_batch_size, False)
    test_loader = loader(te, args.eval_batch_size, False)

    if is_mol:
        num_out = 1 if args.dataset == "ogbg-molhiv" else data.num_classes
        model = GCNMolClassifier(
            emb_dim=args.hidden_size, num_classes=num_out,
            num_layers=args.num_layers, dropout=args.dropout,
            node_encoder="atom" if args.dataset == "ogbg-molhiv" else "embed",
            edge_encoder="bond" if args.dataset == "ogbg-molhiv" else 7,
        )
    else:
        model = GCNGraphClassifier(
            hidden_feats=args.hidden_size, num_classes=data.num_classes,
            num_layers=args.num_layers, dropout=args.dropout,
        )
    tx = optax.adam(args.lr)

    def apply_model(variables, batch, nf, ef, *, train, key=None):
        kwargs = dict(deterministic=not train)
        if train:
            kwargs["rngs"] = {"dropout": key}
            kwargs["mutable"] = ["batch_stats"]
        a = (batch, nf, ef) if is_mol else (batch, nf)
        return model.apply(variables, *a, **kwargs)

    @jax.jit
    def train_step(params, batch_stats, opt_state, batch, nf, ef, y, key):
        gmask = batch.graph_mask()

        def loss_fn(p):
            out, new_state = apply_model(
                {"params": p, "batch_stats": batch_stats}, batch, nf, ef,
                train=True, key=key,
            )
            if args.dataset == "ogbg-molhiv":
                ls = jax.nn.log_sigmoid
                per = -(y * ls(out[:, 0]) + (1.0 - y) * ls(-out[:, 0]))
            else:
                per = softmax_ce_int(out, y)
            loss = jnp.sum(per * gmask) / jnp.maximum(gmask.sum(), 1.0)
            return loss, new_state
        (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_state["batch_stats"], opt_state, loss

    @jax.jit
    def train_epoch_scan(params, batch_stats, opt_state, key, stacked, perm):
        """One dispatch for a whole epoch: scan train_step over the stacked
        device-resident batch cache in `perm` order (--scan-steps)."""

        def body(carry, i):
            params, batch_stats, opt_state, key = carry
            batch, nf, ef, y = jax.tree_util.tree_map(
                lambda a: a[i], stacked)
            key, sub = jax.random.split(key)
            yv = y.astype(jnp.float32) if args.dataset == "ogbg-molhiv" else y
            params, batch_stats, opt_state, loss = train_step(
                params, batch_stats, opt_state, batch, nf, ef, yv, sub)
            return (params, batch_stats, opt_state, key), loss

        (params, batch_stats, opt_state, key), losses = jax.lax.scan(
            body, (params, batch_stats, opt_state, key), perm)
        return params, batch_stats, opt_state, losses[-1]

    @jax.jit
    def predict(params, batch_stats, batch, nf, ef):
        return apply_model({"params": params, "batch_stats": batch_stats}, batch, nf, ef, train=False)

    def evaluate(params, batch_stats, ldr):
        ys, ps = [], []
        for batch, nf, ef, y in ldr:
            out = np.asarray(predict(params, batch_stats, batch, nf, ef))
            m = np.asarray(batch.graph_mask()) > 0
            ys.append(np.asarray(y)[m])
            ps.append(out[m])
        y = np.concatenate(ys)
        p = np.concatenate(ps)
        if args.dataset == "ogbg-molhiv":
            return roc_auc(p[:, 0], y)
        return float((p.argmax(axis=1) == y).mean())

    logger = Logger(args.runs, scale=100.0 if not args.dataset.startswith("ogbg") else 1.0)
    dur = []
    stacked = None  # shared across runs: batch composition is cache-frozen
    for run in range(args.runs):
        key = jax.random.PRNGKey(run)
        b0, nf0, ef0, _ = train_loader.first()
        a0 = (b0, nf0, ef0) if is_mol else (b0, nf0)
        variables = jax.jit(model.init)(key, *a0)
        params, batch_stats = variables["params"], variables.get("batch_stats", {})
        opt_state = tx.init(params)
        for epoch in range(1, args.epochs + 1):
            t0 = time.time()
            if args.scan_steps and stacked is None:
                stacked = train_loader.stacked_cache()  # ready after epoch 1
                if stacked is not None:
                    # the stacked copy supersedes the per-item cache; free it
                    # (ppa buckets are large)
                    train_loader._cache = None
            if stacked is not None:
                st, n_steps = stacked
                key, sub = jax.random.split(key)
                perm = jnp.asarray(
                    train_loader.rng.permutation(n_steps).astype(np.int32))
                params, batch_stats, opt_state, loss = train_epoch_scan(
                    params, batch_stats, opt_state, sub, st, perm)
            else:
                for batch, nf, ef, y in train_loader:
                    key, sub = jax.random.split(key)
                    yv = y.astype(jnp.float32) if args.dataset == "ogbg-molhiv" else y
                    params, batch_stats, opt_state, loss = train_step(
                        params, batch_stats, opt_state, batch, nf, ef, yv, sub
                    )
            loss = float(loss)  # sync point (parity with loss.item())
            if epoch >= 3:
                dur.append(time.time() - t0)
                print("Training time/epoch {}".format(np.mean(dur)))
            if not args.eval:
                continue
            train_acc = evaluate(params, batch_stats, train_eval_loader)
            val_acc = evaluate(params, batch_stats, val_loader)
            test_acc = evaluate(params, batch_stats, test_loader)
            logger.add_result(run, (train_acc, val_acc, test_acc))
            if epoch % args.log_steps == 0:
                print(f"Run: {run + 1:02d}, Epoch: {epoch:02d}, Loss: {loss:.4f}, "
                      f"Train: {train_acc * 100:.4f}% Valid: {val_acc * 100:.4f}% "
                      f"Test: {test_acc * 100:.4f}%")
        if args.eval:
            logger.print_statistics(run)
    if args.eval:
        logger.print_statistics()


if __name__ == "__main__":
    main()
