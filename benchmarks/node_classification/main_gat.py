"""Full-graph GAT node classification (all datasets).

Covers reference N5–N7 (``main_dgl_{citation,reddit,arxiv}_gat.py``).
Per-dataset defaults from the reference argparse blocks: citation — heads
[8,8,1], hidden 8, lr 5e-3, wd 5e-4, dropout 0.6, 200 epochs, self-loops
(``main_dgl_citation_gat.py:85-146``); reddit — heads [1,1,1], hidden 16,
tuned lr/wd/dropout, 500 epochs (``main_dgl_reddit_gat.py:85-145``);
arxiv — heads [4,4,4], bidirected + self-loops, tuned hyperparams
(``main_dgl_arxiv_gat.py:100-139``).
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
    adam_l2,
    load_node_dataset,
    masked_accuracy,
    masked_softmax_ce,
    prepare_full_graph,
    print_data_stats,
    Logger,
)

import dgl_jax  # noqa: E402
from dgl_jax.graph import transforms  # noqa: E402
from dgl_jax.models import GAT  # noqa: E402

_TUNED = dict(lr=0.0029739421726400865, wd=2.4222556964495987e-05, dropout=0.18074706609292976)

DATASET_CFG = {
    "cora": dict(heads=(8, 8, 1), hidden=8, lr=5e-3, wd=5e-4, dropout=0.6, epochs=200, bidirect=False),
    "pubmed": dict(heads=(8, 8, 1), hidden=8, lr=5e-3, wd=5e-4, dropout=0.6, epochs=200, bidirect=False),
    "reddit": dict(heads=(1, 1, 1), hidden=16, epochs=500, bidirect=False, **_TUNED),
    "ogbn-arxiv": dict(heads=(4, 4, 4), hidden=16, epochs=500, bidirect=True, **_TUNED),
}


def run_sharded(args, cfg, heads, data):
    """Edge-partitioned full-graph GAT: boundary-halo exchange with
    edge-softmax across shard boundaries (``dgl_jax.parallel.halo``,
    pattern of ``main_sage.py:run_sharded``)."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dgl_jax.graph import transforms
    from dgl_jax.graph.partition import partition_assignment
    from dgl_jax.parallel import (
        device_mesh,
        halo_gat_apply,
        halo_gat_init,
        make_halo_gat_train_step,
        shard_fullgraph_boundary,
    )

    k = args.shard if args.shard > 0 else len(jax.devices())
    src, dst = data.src, data.dst
    if cfg["bidirect"]:
        src, dst = transforms.to_bidirected(src, dst, data.num_nodes)
    src, dst = transforms.add_self_loops(src, dst, data.num_nodes)

    part = partition_assignment(src, dst, data.num_nodes, k, seed=args.seed)
    order = np.argsort(part, kind="stable")
    new_id = np.empty(data.num_nodes, np.int64)
    new_id[order] = np.arange(data.num_nodes)
    src, dst = new_id[src], new_id[dst]

    bs, n_pad = shard_fullgraph_boundary(src, dst, data.num_nodes, k)
    mesh = device_mesh((1, k), ("data", "graph"), devices=jax.devices()[:k])
    row = NamedSharding(mesh, P("graph"))
    rep = NamedSharding(mesh, P())

    def pad_rows(a, fill=0):
        out = np.full((n_pad,) + a.shape[1:], fill, a.dtype)
        out[: data.num_nodes] = a[order]
        return out

    x = jax.device_put(jnp.asarray(pad_rows(data.features)), row)
    y = jax.device_put(jnp.asarray(pad_rows(data.labels)), row)
    masks = {
        m: jax.device_put(jnp.asarray(pad_rows(getattr(data, f"{m}_mask"))), row)
        for m in ("train", "val", "test")
    }
    bs = jax.device_put(bs, jax.tree_util.tree_map(lambda _: row, bs))

    tx = adam_l2(cfg["lr"], cfg["wd"])
    train_step = make_halo_gat_train_step(mesh, tx, heads)

    @jax.jit
    def eval_step(params, bs, x, y, masks):
        logits = halo_gat_apply(params, bs, x, mesh, heads=heads)
        pred = jnp.argmax(logits, axis=1)
        out = []
        for m in ("train", "val", "test"):
            mm = masks[m].astype(jnp.float32)
            out.append(jnp.sum((pred == y) * mm) / jnp.maximum(jnp.sum(mm), 1.0))
        return tuple(out)

    logger = Logger(args.runs)
    dur = []
    for run in range(args.runs):
        key = jax.random.PRNGKey(args.seed * 1000 + run)
        params = jax.device_put(
            halo_gat_init(key, data.features.shape[1], cfg["hidden"],
                          data.num_classes, heads=heads),
            rep,
        )
        opt_state = jax.device_put(tx.init(params), rep)
        for epoch in range(cfg["epochs"]):
            if epoch >= 3:
                t0 = time.time()
            params, opt_state, loss = train_step(params, opt_state, bs, x, y,
                                                 masks["train"])
            loss = float(loss)
            if epoch >= 3:
                dur.append(time.time() - t0)
                print("Training time/epoch {}".format(np.mean(dur)))
            if args.eval:
                accs = tuple(map(float, eval_step(params, bs, x, y, masks)))
                logger.add_result(run, accs)
                print(
                    "Run {:02d} | Epoch {:05d} | Loss {:.4f} | Train {:.4f} | Val {:.4f} | Test {:.4f}".format(
                        run, epoch, loss, *accs
                    )
                )
        if args.eval:
            logger.print_statistics(run)
    if args.eval:
        logger.print_statistics()


def main():
    parser = argparse.ArgumentParser(description="GAT (dgl_jax)")
    parser.add_argument("--dataset", type=str, default="cora", choices=sorted(DATASET_CFG))
    parser.add_argument("--device", type=int, default=0)
    parser.add_argument("--num-layers", type=int, default=3)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--weight-decay", type=float, default=None)
    parser.add_argument("--num-hidden", type=int, default=None)
    parser.add_argument("--dropout", type=float, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--eval", action="store_true",
                        help="If not set, we will only do the training part.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lowering", choices=("fused", "scatter"),
                        default="fused",
                        help="message-passing lowering: fused custom-VJP "
                             "sorted reductions (DGL-style) vs explicit "
                             "gather + plain segment op (PyG-twin, N10)")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="shrink factor for synthetic fallback data (smoke tests)")
    parser.add_argument("--reorder", action="store_true",
                        help="relabel nodes by a locality partition (hub "
                             "extraction + multilevel blocks) before building "
                             "the graph")
    parser.add_argument("--shard", type=int, default=0,
                        help="edge-partitioned full-graph training over a "
                             "device mesh: boundary-halo exchange with "
                             "cross-shard edge-softmax (0 = off; -1 = all "
                             "local devices; N = N-way)")
    parser.add_argument("--scan-epochs", type=int, default=1,
                        help="epochs per device dispatch via lax.scan (>1 "
                             "amortizes the per-dispatch latency that "
                             "dominates tiny graphs; engages only without "
                             "--eval, identical rng sequence to the loop)")
    args = parser.parse_args()
    cfg = DATASET_CFG[args.dataset]
    for flag, key in [("lr", "lr"), ("weight_decay", "wd"), ("num_hidden", "hidden"),
                      ("dropout", "dropout"), ("epochs", "epochs")]:
        v = getattr(args, flag)
        if v is not None:
            cfg[key] = v
    heads = tuple(cfg["heads"][: args.num_layers])
    print(args)
    if args.lowering == "scatter":
        os.environ["DGL_JAX_LOWERING"] = "scatter"

    data = load_node_dataset(args.dataset, seed=args.seed, scale=args.scale)
    print_data_stats(data)

    if args.shard:
        run_sharded(args, cfg, heads, data)
        return

    g, features, labels, mask_arrays, _ = prepare_full_graph(
        args.dataset, data, scale=args.scale, seed=args.seed,
        bidirect=cfg["bidirect"], self_loops=True, reorder=args.reorder,
        order_key=f"{args.dataset}_s{args.scale}_gat",
    )
    x = jnp.asarray(features)
    y = jnp.asarray(labels)
    masks = {k: jnp.asarray(v) for k, v in mask_arrays.items()}

    model = GAT(
        hidden_feats=cfg["hidden"],
        out_feats=data.num_classes,
        heads=heads,
        feat_drop=cfg["dropout"],
        attn_drop=cfg["dropout"],
    )
    tx = adam_l2(cfg["lr"], cfg["wd"])

    def _train_step_body(params, opt_state, key, g, x, y, masks):
        def loss_fn(p):
            logits = model.apply(
                {"params": p}, g, x, deterministic=False, rngs={"dropout": key}
            )
            return masked_softmax_ce(logits, y, masks["train"])
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    train_step = jax.jit(_train_step_body)

    from functools import partial

    @partial(jax.jit, static_argnames=("k",))
    def train_chunk(params, opt_state, key, g, x, y, masks, k):
        """k epochs in ONE dispatch (identical rng sequence to the loop)."""
        def body(carry, _):
            params, opt_state, key = carry
            key, sub = jax.random.split(key)
            params, opt_state, loss = _train_step_body(
                params, opt_state, sub, g, x, y, masks
            )
            return (params, opt_state, key), loss
        (params, opt_state, key), losses = jax.lax.scan(
            body, (params, opt_state, key), None, length=k
        )
        return params, opt_state, key, losses[-1]

    @jax.jit
    def eval_step(params, g, x, y, masks):
        logits = model.apply({"params": params}, g, x, deterministic=True)
        return tuple(masked_accuracy(logits, y, masks[k]) for k in ("train", "val", "test"))

    logger = Logger(args.runs)
    dur = []
    for run in range(args.runs):
        key = jax.random.PRNGKey(args.seed * 1000 + run)
        params = jax.jit(model.init)(key, g, x)["params"]
        opt_state = tx.init(params)
        scan_k = args.scan_epochs if (args.scan_epochs > 1 and not args.eval) else 1
        epoch = 0
        while epoch < cfg["epochs"]:
            k = min(scan_k, cfg["epochs"] - epoch)
            if epoch >= 3:
                t0 = time.time()
            if k > 1:
                params, opt_state, key, loss = train_chunk(
                    params, opt_state, key, g, x, y, masks, k=k
                )
            else:
                key, sub = jax.random.split(key)
                params, opt_state, loss = train_step(params, opt_state, sub, g, x, y, masks)
            loss = float(loss)
            if epoch >= 3:
                dur.append((time.time() - t0) / k)
                print("Training time/epoch {}".format(np.mean(dur)))
            if args.eval:
                accs = tuple(map(float, eval_step(params, g, x, y, masks)))
                logger.add_result(run, accs)
                print(
                    "Run {:02d} | Epoch {:05d} | Loss {:.4f} | Train {:.4f} | Val {:.4f} | Test {:.4f}".format(
                        run, epoch, loss, *accs
                    )
                )
            epoch += k
        if args.eval:
            logger.print_statistics(run)
    if args.eval:
        logger.print_statistics()


if __name__ == "__main__":
    main()
