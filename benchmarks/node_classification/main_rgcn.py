"""Full-graph RGCN on ogbn-proteins (reference N8,
``main_dgl_proteins_rgcn_for.py``).

Semantics preserved: node features = ones((N,1)) (``:155``), edge weights =
the 8 columns of the edge feature matrix (``:159-161``), multilabel
BCE-with-logits on train nodes (``:101``), mean per-task ROC-AUC eval every
``--eval_steps`` (``:112-130``), plain Adam lr 0.01, 3 layers hidden 32.
"""

import argparse
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, __file__.rsplit("/benchmarks/", 1)[0] + "/benchmarks")
from common import (  # noqa: E402
    load_node_dataset,
    masked_bce,
    mean_multilabel_auc,
    prepare_full_graph,
    print_data_stats,
    Logger,
)

import dgl_jax  # noqa: E402
from dgl_jax.models import RGCN  # noqa: E402


def run_sharded(args, data):
    """Edge-partitioned full-graph RGCN: relation-contracted boundary-halo
    exchange (``dgl_jax.parallel.halo_rgcn_boundary``; pattern of
    ``main_sage.py:run_sharded``). Eval = mean ROC-AUC over masked rows."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from common import mean_multilabel_auc
    from dgl_jax.graph.partition import partition_assignment
    from dgl_jax.parallel import (
        device_mesh,
        halo_rgcn_apply,
        halo_rgcn_init,
        make_halo_rgcn_train_step,
        plan_layout_edata_boundary,
        shard_fullgraph_boundary,
    )

    k = args.shard if args.shard > 0 else len(jax.devices())
    src, dst = data.src, data.dst
    n_rel = data.edge_feat.shape[1]

    part = partition_assignment(src, dst, data.num_nodes, k, seed=args.seed)
    order = np.argsort(part, kind="stable")
    new_id = np.empty(data.num_nodes, np.int64)
    new_id[order] = np.arange(data.num_nodes)
    src, dst = new_id[src], new_id[dst]

    bs, n_pad, leids, heids = shard_fullgraph_boundary(
        src, dst, data.num_nodes, k, return_eids=True)
    w_loc, w_hal = plan_layout_edata_boundary(bs, leids, heids, data.edge_feat)
    mesh = device_mesh((1, k), ("data", "graph"), devices=jax.devices()[:k])
    row = NamedSharding(mesh, P("graph"))
    rep = NamedSharding(mesh, P())

    def pad_rows(a, fill=0):
        out = np.full((n_pad,) + a.shape[1:], fill, np.asarray(a).dtype)
        out[: data.num_nodes] = np.asarray(a)[order]
        return out

    x = jax.device_put(jnp.ones((n_pad, 1), jnp.float32), row)
    y = jax.device_put(jnp.asarray(pad_rows(data.labels.astype(np.float32))), row)
    masks = {
        m: jax.device_put(jnp.asarray(pad_rows(getattr(data, f"{m}_mask"))), row)
        for m in ("train", "val", "test")
    }
    bs = jax.device_put(bs, jax.tree_util.tree_map(lambda _: row, bs))
    w_loc, w_hal = jax.device_put(w_loc, row), jax.device_put(w_hal, row)

    tx = optax.adam(args.lr)
    train_step = make_halo_rgcn_train_step(mesh, tx, n_rel)

    @jax.jit
    def forward(params, bs, x, wl, wh):
        return halo_rgcn_apply(params, bs, x, wl, wh, n_rel, mesh)

    dur = []
    for run in range(args.runs):
        key = jax.random.PRNGKey(args.seed * 1000 + run)
        params = jax.device_put(
            halo_rgcn_init(key, 1, args.hidden_feats, data.labels.shape[1],
                           n_rel, args.num_layers),
            rep,
        )
        opt_state = jax.device_put(tx.init(params), rep)
        for epoch in range(args.epochs):
            if epoch >= 3:
                t0 = time.time()
            params, opt_state, loss = train_step(params, opt_state, bs, x,
                                                 w_loc, w_hal, y, masks["train"])
            loss = float(loss)
            if epoch >= 3:
                dur.append(time.time() - t0)
                print("Training time/epoch {}".format(np.mean(dur)))
            if args.eval and (epoch + 1) % args.eval_steps == 0:
                scores = np.asarray(forward(params, bs, x, w_loc, w_hal))
                aucs = []
                for m in ("train", "val", "test"):
                    mm = np.asarray(masks[m])
                    aucs.append(mean_multilabel_auc(
                        scores[mm], np.asarray(y)[mm]))
                print(
                    "Run {:02d} | Epoch {:05d} | Loss {:.4f} | Train {:.4f} | Val {:.4f} | Test {:.4f}".format(
                        run, epoch, loss, *aucs
                    )
                )


def main():
    parser = argparse.ArgumentParser(description="RGCN ogbn-proteins (dgl_jax)")
    parser.add_argument("--device", type=int, default=0)
    parser.add_argument("--log_steps", type=int, default=1)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--num-layers", type=int, default=3)
    parser.add_argument("--hidden-feats", type=int, default=32)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--eval_steps", type=int, default=5)
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--eval", action="store_true",
                        help="If not set, we will only do the training part.")
    parser.add_argument("--fuse-relations", action="store_true",
                        help="batch relations into one fused SpMM (more memory)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--scale", type=float, default=1.0,
                        help="shrink factor for synthetic fallback data (smoke tests)")
    parser.add_argument("--reorder", action="store_true",
                        help="relabel nodes by a locality partition (hub "
                             "extraction + multilevel blocks) before building "
                             "the graph")
    parser.add_argument("--shard", type=int, default=0,
                        help="edge-partitioned full-graph training over a "
                             "device mesh: relation-contracted boundary-halo "
                             "exchange (0 = off; -1 = all devices; N = N-way)")
    args = parser.parse_args()
    print(args)

    data = load_node_dataset("ogbn-proteins", seed=args.seed, scale=args.scale)
    print_data_stats(data)

    if args.shard:
        run_sharded(args, data)
        return

    # prepare_full_graph permutes every node-indexed array by the order
    g, _, labels, mask_arrays, _ = prepare_full_graph(
        "ogbn-proteins", data, scale=args.scale, seed=0,
        reorder=args.reorder, order_key=f"proteins_s{args.scale}_rgcn",
    )
    node_feats = jnp.ones((data.num_nodes, 1), dtype=jnp.float32)
    edge_weights = g.permute_edata(jnp.asarray(data.edge_feat))  # (E_pad, 8)
    y = jnp.asarray(labels, dtype=jnp.float32)  # (N, 112) multilabel
    masks = {k: jnp.asarray(v) for k, v in mask_arrays.items()}

    model = RGCN(
        hidden_feats=args.hidden_feats,
        out_feats=y.shape[-1],
        num_relations=edge_weights.shape[-1],
        num_layers=args.num_layers,
        dropout=args.dropout,
        fuse_relations=args.fuse_relations,
    )
    tx = optax.adam(args.lr)

    @jax.jit
    def train_step(params, opt_state, key, g, node_feats, edge_weights, y, masks):
        def loss_fn(p):
            out = model.apply(
                {"params": p}, g, node_feats, edge_weights,
                deterministic=False, rngs={"dropout": key},
            )
            return masked_bce(out, y, masks["train"])
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def forward(params, g, node_feats, edge_weights):
        return model.apply({"params": params}, g, node_feats, edge_weights)

    logger = Logger(args.runs, scale=100.0)
    dur = []
    for run in range(args.runs):
        key = jax.random.PRNGKey(args.seed * 1000 + run)
        params = jax.jit(model.init)(key, g, node_feats, edge_weights)["params"]
        opt_state = tx.init(params)
        for epoch in range(args.epochs):
            key, sub = jax.random.split(key)
            if epoch >= 3:
                t0 = time.time()
            params, opt_state, loss = train_step(
                params, opt_state, sub, g, node_feats, edge_weights, y, masks)
            loss = float(loss)
            if epoch >= 3:
                dur.append(time.time() - t0)
                print("Training time/epoch {}".format(np.mean(dur)))
            if args.eval and (epoch + 1) % args.eval_steps == 0:
                scores = np.asarray(forward(params, g, node_feats, edge_weights))
                labels_np = np.asarray(y)
                aucs = tuple(
                    mean_multilabel_auc(
                        scores[np.asarray(mask_arrays[k])],
                        labels_np[np.asarray(mask_arrays[k])],
                    )
                    for k in ("train", "val", "test")
                )
                logger.add_result(run, aucs)
                print(
                    "Run {:02d} | Epoch {:05d} | Loss {:.4f} | Train {:.4f} | Val {:.4f} | Test {:.4f}".format(
                        run, epoch, loss, *aucs
                    )
                )
        if args.eval:
            logger.print_statistics(run)
    if args.eval:
        logger.print_statistics()


if __name__ == "__main__":
    main()
