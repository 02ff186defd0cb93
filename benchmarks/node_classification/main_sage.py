"""Full-graph GraphSAGE node classification (all datasets).

Driver covering the reference's N1–N4 + N9 workloads in one CLI
(``main_dgl_{citation,reddit,arxiv,product}_sage.py``): per-dataset defaults
match the reference argparse blocks (citation: 2-layer hidden 16 / lr 1e-2 /
wd 5e-4 / 200 epochs — ``main_dgl_citation_sage.py:130-148``; arxiv:
3-layer hidden 256 + BatchNorm / 500 epochs — ``main_dgl_arxiv_sage.py:
141-149``; products: 3-layer hidden 64 / 300 epochs, bidirected graph).
Stdout format (``Training time/epoch``, Logger stats) is harness-parsed.
"""

import argparse
import os
import sys
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/benchmarks/", 1)[0] + "/benchmarks")
from common import (  # noqa: E402
    adam_l2,
    data_cache_suffix,
    load_node_dataset,
    masked_accuracy,
    masked_softmax_ce,
    prepare_full_graph,
    print_data_stats,
    Logger,
)

import dgl_jax  # noqa: E402
from dgl_jax.graph import transforms  # noqa: E402
from dgl_jax.models import GraphSAGE  # noqa: E402

DATASET_CFG = {
    "cora": dict(layers=2, hidden=16, lr=1e-2, wd=5e-4, dropout=0.5, epochs=200, bn=False, bidirect=False),
    "pubmed": dict(layers=2, hidden=16, lr=1e-2, wd=5e-4, dropout=0.5, epochs=200, bn=False, bidirect=False),
    "reddit": dict(layers=2, hidden=16, lr=1e-2, wd=5e-4, dropout=0.5, epochs=200, bn=False, bidirect=False),
    "ogbn-arxiv": dict(layers=3, hidden=256, lr=1e-2, wd=0.0, dropout=0.5, epochs=500, bn=True, bidirect=True),
    "ogbn-products": dict(layers=3, hidden=64, lr=1e-2, wd=0.0, dropout=0.5, epochs=300, bn=False, bidirect=True),
}


def shard_setup(k, cfg, data, seed=0, aggr="mean"):
    """Place a full graph for edge-partitioned training on the first ``k``
    devices: nodes relabeled into contiguous locality blocks (one per
    device), a ``(1, k)`` ``("data", "graph")`` mesh, row-sharded features,
    labels and masks, and the jitted halo train step.

    Returns a dict with ``mesh``, ``bs`` (boundary plan), ``x``, ``y``,
    ``masks``, ``tx``, ``train_step``, ``eval_step``, ``n_pad`` and
    ``order`` (the relabeling: new row i holds original node order[i])."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dgl_jax.graph.partition import partition_assignment
    from dgl_jax.parallel import (
        device_mesh,
        exchange_stats,
        halo_sage_apply,
        make_halo_train_step,
        shard_fullgraph_boundary,
    )

    src, dst = data.src, data.dst
    if cfg["bidirect"]:
        src, dst = transforms.to_bidirected(src, dst, data.num_nodes)

    # locality relabel → contiguous per-device ranges with small boundaries
    part = partition_assignment(src, dst, data.num_nodes, k, seed=seed)
    order = np.argsort(part, kind="stable")
    new_id = np.empty(data.num_nodes, np.int64)
    new_id[order] = np.arange(data.num_nodes)
    src, dst = new_id[src], new_id[dst]

    t0 = time.time()
    bs, n_pad = shard_fullgraph_boundary(src, dst, data.num_nodes, k)
    stats = exchange_stats(bs, cfg["hidden"])
    print(
        "shard plan: k={} nodes/shard={} H={} volume_ratio={:.3f} build_s={:.1f}".format(
            k, bs.nodes_per_shard, bs.rows_per_pair, stats["volume_ratio"],
            time.time() - t0,
        )
    )

    mesh = device_mesh((1, k), ("data", "graph"), devices=jax.devices()[:k])
    row = NamedSharding(mesh, P("graph"))

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
    train_step = make_halo_train_step(mesh, tx, aggr=aggr,
                                      dropout=cfg["dropout"])

    @jax.jit
    def eval_step(params, bs, x, y, masks):
        logits = halo_sage_apply(params, bs, x, mesh, aggr=aggr)
        pred = jnp.argmax(logits, axis=1)
        out = []
        for m in ("train", "val", "test"):
            mm = masks[m].astype(jnp.float32)
            out.append(jnp.sum((pred == y) * mm) / jnp.maximum(jnp.sum(mm), 1.0))
        return tuple(out)

    return dict(mesh=mesh, bs=bs, x=x, y=y, masks=masks, tx=tx,
                train_step=train_step, eval_step=eval_step, n_pad=n_pad,
                order=order)


def run_sharded(args, cfg, data):
    """Edge-partitioned full-graph training: boundary-halo all_to_all per
    layer (``dgl_jax.parallel.halo``). This is the path that deletes the
    reference's full-graph OOM rows (``README.md:43,46``) — memory per
    device is N/k rows + the boundary halo."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dgl_jax.parallel import halo_sage_init

    k = args.shard if args.shard > 0 else len(jax.devices())
    s = shard_setup(k, cfg, data, seed=args.seed, aggr=args.aggr)
    mesh, bs, x, y, masks, tx = (s[n] for n in ("mesh", "bs", "x", "y", "masks", "tx"))
    train_step, eval_step = s["train_step"], s["eval_step"]
    rep = NamedSharding(mesh, P())

    logger = Logger(args.runs)
    dur = []
    for run in range(args.runs):
        key = jax.random.PRNGKey(args.seed * 1000 + run)
        key, init_key = jax.random.split(key)
        params = jax.device_put(
            halo_sage_init(init_key, data.features.shape[1], cfg["hidden"],
                           data.num_classes, cfg["layers"]),
            rep,
        )
        opt_state = jax.device_put(tx.init(params), rep)
        for epoch in range(cfg["epochs"]):
            key, sub = jax.random.split(key)
            if epoch >= 3:
                t0 = time.time()
            params, opt_state, loss = train_step(params, opt_state, sub, bs,
                                                 x, y, masks["train"])
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
    parser = argparse.ArgumentParser(description="GraphSAGE (dgl_jax)")
    parser.add_argument("--dataset", type=str, default="cora", choices=sorted(DATASET_CFG))
    parser.add_argument("--device", type=int, default=0)
    parser.add_argument("--dropout", type=float, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--n-hidden", type=int, default=None)
    parser.add_argument("--num-layers", type=int, default=None)
    parser.add_argument("--aggr", type=str, choices=["sum", "mean"], default="mean")
    parser.add_argument("--weight-decay", type=float, default=None)
    parser.add_argument("--eval", action="store_true",
                        help="If not set, we will only do the training part.")
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt-dir", type=str, default=None,
                        help="enable checkpoint/resume in this directory")
    parser.add_argument("--ckpt-every", type=int, default=50)
    parser.add_argument("--scan-epochs", type=int, default=1,
                        help="epochs per device dispatch (lax.scan): amortizes "
                             "the per-call dispatch latency that dominates "
                             "small graphs; applies when --eval is not set")
    parser.add_argument("--reorder", action="store_true",
                        help="relabel nodes by a locality partition (hub "
                             "extraction + multilevel blocks) before building "
                             "the graph")
    parser.add_argument("--bf16-messages", action="store_true",
                        help="bf16 neighbor messages (halves the E x D "
                             "intermediate; f32 accumulation)")
    parser.add_argument("--no-precompute", action="store_true",
                        help="disable hoisting the (training-constant) layer-1 "
                             "neighbor aggregation out of the step")
    parser.add_argument("--lowering", choices=("fused", "scatter"),
                        default="fused",
                        help="message-passing lowering: fused custom-VJP "
                             "sorted reductions (DGL-style) vs explicit "
                             "gather + plain segment op (PyG-twin, N10)")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="shrink factor for synthetic fallback data (smoke tests)")
    parser.add_argument("--shard", type=int, default=0,
                        help="edge-partitioned full-graph training over an "
                             "N-device 'graph' mesh (boundary-halo all_to_all "
                             "per layer; removes the reference's OOM rows). "
                             "0 = off, -1 = all visible devices")
    args = parser.parse_args()
    cfg = DATASET_CFG[args.dataset]
    for flag, key in [("dropout", "dropout"), ("lr", "lr"), ("epochs", "epochs"),
                      ("n_hidden", "hidden"), ("num_layers", "layers"),
                      ("weight_decay", "wd")]:
        v = getattr(args, flag)
        if v is not None:
            cfg[key] = v
    print(args)
    if args.lowering == "scatter":
        os.environ["DGL_JAX_LOWERING"] = "scatter"

    data = load_node_dataset(args.dataset, seed=args.seed, scale=args.scale)
    print_data_stats(data)

    if args.shard:
        run_sharded(args, cfg, data)
        return

    if (len(data.src) * (2 if cfg["bidirect"] else 1)) > 80_000_000:
        # ogbn-products scale: several chunked SpMM passes coexist in one
        # step program and XLA double-buffers their chunk loops, so each
        # op's message budget drops to a sixteenth of device memory.
        from dgl_jax.memory import memory_share

        os.environ.setdefault("DGL_JAX_MSG_BUDGET_GB",
                              str(memory_share(1 / 16) / (1 << 30)))
    from dgl_jax.data.loaders import data_root

    g, features, labels, mask_arrays, _ = prepare_full_graph(
        args.dataset, data, scale=args.scale, seed=args.seed,
        bidirect=cfg["bidirect"], reorder=args.reorder,
        order_key=f"{args.dataset}_s{args.scale}",
    )
    x = jnp.asarray(features)
    y = jnp.asarray(labels)
    masks = {k: jnp.asarray(v) for k, v in mask_arrays.items()}

    # Hoist the layer-1 aggregation of the constant input features out of
    # the hot loop (exact; see GraphSAGE docstring / reference use_pp trick).
    # Disk-cached for big graphs: at products scale the chunked exact pass
    # is minutes of device time, identical on every subprocess/retry.
    x_agg = None
    if not args.no_precompute:
        from dgl_jax.ops.spmm import gspmm_chunked

        agg_path = None
        if g.num_edges > 4_000_000:
            agg_path = os.path.join(
                data_root(),
                f"xagg_{args.dataset}_s{args.scale}_sd{args.seed}"
                f"_{args.aggr}_r{int(args.reorder)}"
                f"{data_cache_suffix(data)}.npy")
        if agg_path and os.path.exists(agg_path):
            x_agg = jnp.asarray(np.load(agg_path))
        else:
            x_agg = gspmm_chunked(g, "copy_u", args.aggr, x)
            jax.block_until_ready(x_agg)
            if agg_path:
                tmp = agg_path + f".tmp{os.getpid()}.npy"
                np.save(tmp, np.asarray(x_agg))
                os.replace(tmp, agg_path)

    model = GraphSAGE(
        hidden_feats=cfg["hidden"],
        out_feats=data.num_classes,
        num_layers=cfg["layers"],
        aggr=args.aggr,
        dropout=cfg["dropout"],
        batch_norm=cfg["bn"],
        msg_dtype=jnp.bfloat16 if args.bf16_messages else None,
    )
    tx = adam_l2(cfg["lr"], cfg["wd"])

    # NB: graph/features/labels are jit *arguments*, never closures — closed-
    # over arrays are baked into the HLO as constants (OOMs the compiler on
    # reddit/products-sized data).
    def _train_step_body(params, batch_stats, opt_state, key, g, x, y, masks, x_agg):
        def loss_fn(p):
            variables = {"params": p, **({"batch_stats": batch_stats} if batch_stats else {})}
            out = model.apply(
                variables, g, x, x_agg=x_agg, deterministic=False,
                rngs={"dropout": key},
                mutable=["batch_stats"] if batch_stats else False,
            )
            logits, new_state = out if batch_stats else (out, {})
            return masked_softmax_ce(logits, y, masks["train"]), new_state
        (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return params, new_state.get("batch_stats", batch_stats), opt_state, loss

    train_step = jax.jit(_train_step_body)

    @partial(jax.jit, static_argnames=("k",))
    def train_chunk(params, batch_stats, opt_state, key, g, x, y, masks, x_agg, k):
        """k epochs in ONE dispatch (identical rng sequence to the loop)."""
        def body(carry, _):
            params, batch_stats, opt_state, key = carry
            key, sub = jax.random.split(key)
            params, batch_stats, opt_state, loss = _train_step_body(
                params, batch_stats, opt_state, sub, g, x, y, masks, x_agg
            )
            return (params, batch_stats, opt_state, key), loss
        (params, batch_stats, opt_state, key), losses = jax.lax.scan(
            body, (params, batch_stats, opt_state, key), None, length=k
        )
        return params, batch_stats, opt_state, key, losses[-1]

    @jax.jit
    def eval_step(params, batch_stats, g, x, y, masks, x_agg):
        variables = {"params": params, **({"batch_stats": batch_stats} if batch_stats else {})}
        logits = model.apply(variables, g, x, x_agg=x_agg, deterministic=True)
        return tuple(masked_accuracy(logits, y, masks[k]) for k in ("train", "val", "test"))

    ckpt = None
    if args.ckpt_dir:
        from dgl_jax.train import CheckpointManager
        ckpt = CheckpointManager(args.ckpt_dir, save_interval=args.ckpt_every)

    logger = Logger(args.runs)
    dur = []
    for run in range(args.runs):
        key = jax.random.PRNGKey(args.seed * 1000 + run)
        variables = jax.jit(model.init)(key, g, x, x_agg=x_agg)
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})
        opt_state = tx.init(params)
        start_epoch = 0
        if ckpt is not None and run == 0:
            (params, batch_stats, opt_state, key), start_epoch = ckpt.restore_or(
                (params, batch_stats, opt_state, key)
            )
            if start_epoch:
                print(f"resumed from checkpoint at epoch {start_epoch}")
        # Multi-epoch scan dispatch: k epochs per device call amortizes the
        # per-dispatch latency that dominates small graphs. Only when not
        # --eval (eval needs per-epoch accuracies); rng sequence matches the
        # loop.
        scan_k = args.scan_epochs if (args.scan_epochs > 1 and not args.eval) else 1
        epoch = start_epoch
        while epoch < cfg["epochs"]:
            k = min(scan_k, cfg["epochs"] - epoch)
            if epoch >= 3:
                t0 = time.time()
            if k > 1:
                params, batch_stats, opt_state, key, loss = train_chunk(
                    params, batch_stats, opt_state, key, g, x, y, masks, x_agg, k=k
                )
            else:
                key, sub = jax.random.split(key)
                params, batch_stats, opt_state, loss = train_step(params, batch_stats, opt_state, sub, g, x, y, masks, x_agg)
            loss = float(loss)  # sync point (parity with loss.item())
            if epoch >= 3:
                dur.append((time.time() - t0) / k)
                print("Training time/epoch {}".format(np.mean(dur)))
            if ckpt is not None and run == 0:
                ckpt.save(epoch + k - 1, (params, batch_stats, opt_state, key))
            if args.eval:
                accs = tuple(map(float, eval_step(params, batch_stats, g, x, y, masks, x_agg)))
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
