"""Neighbor-sampled minibatch GraphSAGE (reference S1/S4:
``sampling/node-classification/reddit/ns-sage-dgl.py``,
``ogbn-product/ns-sage/ns-sage-dgl.py``).

Reference conventions preserved: fanout list ``--fan-out 10,25``
(``ns-sage-dgl.py:199``), batch 1000, lr 3e-3, per-step throughput log
(``:171-176``), ``Epoch Time(s):`` line with 5-epoch warmup skip
(``:181-182``), eval every ``--eval-every`` epochs via layer-wise full-graph
inference (our full-graph kernels make the reference's batched ping-pong
``inference`` loop (``:50-90``) unnecessary — one full-graph forward per
layer is the same computation without host round-trips).

Pipeline: host numpy sampler (static-shape blocks, see
``dgl_jax/sampling/neighbor.py``) in a prefetch thread; features stay
device-resident and are row-gathered on device per step.
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
    masked_accuracy,
    masked_softmax_ce,
    print_data_stats,
)

import dgl_jax  # noqa: E402
from dgl_jax.models import GraphSAGE  # noqa: E402
from dgl_jax.sampling import (  # noqa: E402
    CSRGraph,
    DeviceNeighborSampler,
    MultiLayerNeighborSampler,
    NodeDataLoader,
)


def main():
    p = argparse.ArgumentParser(description="Neighbor-sampling SAGE (dgl_jax)")
    p.add_argument("--gpu", type=int, default=0)
    p.add_argument("--dataset", type=str, default="reddit",
                   choices=["reddit", "ogbn-products", "ogbn-arxiv", "cora", "pubmed"])
    p.add_argument("--num-epochs", type=int, default=20)
    p.add_argument("--num-hidden", type=int, default=16)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--fan-out", type=str, default="10,25")
    p.add_argument("--batch-size", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--eval-every", type=int, default=5)
    p.add_argument("--lr", type=float, default=0.003)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--inductive", action="store_true",
                   help="inductive split: sample/train only on the train-node "
                        "subgraph (reference ns-sage-dgl.py:225-228)")
    p.add_argument("--host-sampler", action="store_true",
                   help="sample on host threads (the round-1/2 path) instead "
                        "of on device; device sampling cuts per-step H2D to "
                        "the seed ids")
    p.add_argument("--no-replace", action="store_true",
                   help="without-replacement neighbor sampling (distinct "
                        "neighbors per seed — DGL's MultiLayerNeighborSampler "
                        "default, reference ns-sage-dgl.py:132); implies "
                        "--host-sampler")
    p.add_argument("--scan-steps", action="store_true",
                   help="device-sampler mode only: run each epoch (on-device "
                        "sampling + train steps) as ONE lax.scan dispatch "
                        "over the shuffled seed matrix")
    args = p.parse_args()
    if args.no_replace:
        args.host_sampler = True
    print(args)

    data = load_node_dataset(args.dataset, seed=args.seed, scale=args.scale)
    print_data_stats(data)
    fanouts = [int(f) for f in args.fan_out.split(",")]
    if len(fanouts) != args.num_layers:
        raise ValueError("--fan-out length must equal --num-layers")

    train_nid = np.where(data.train_mask)[0]
    val_nid = np.where(data.val_mask)[0]
    test_nid = np.where(data.test_mask)[0]
    src_tr, dst_tr = data.src, data.dst
    if args.inductive:
        # train-time graph = node-induced subgraph on train nodes, with ids
        # kept GLOBAL so features/labels index unchanged
        from dgl_jax.graph.transforms import node_subgraph
        keep = np.zeros(data.num_nodes, bool); keep[train_nid] = True
        m = keep[data.src] & keep[data.dst]
        src_tr, dst_tr = data.src[m], data.dst[m]
    csr = CSRGraph.from_edges(src_tr, dst_tr, data.num_nodes)
    g_full = dgl_jax.from_edges(data.src, data.dst, data.num_nodes)
    x = jnp.asarray(data.features)
    y = jnp.asarray(data.labels)

    sampler = MultiLayerNeighborSampler(fanouts, replace=not args.no_replace)
    if args.host_sampler:
        loader = NodeDataLoader(csr, train_nid, sampler, args.batch_size, seed=args.seed)
    else:
        dsampler = DeviceNeighborSampler(csr, fanouts)
        loader_rng = np.random.default_rng(args.seed)
        dkey = jax.random.PRNGKey(args.seed + 17)

        def device_loader():
            nonlocal dkey
            idx = loader_rng.permutation(train_nid)
            for i in range(0, len(idx), args.batch_size):
                dkey, sub = jax.random.split(dkey)
                yield dsampler.sample(idx[i : i + args.batch_size], sub,
                                      args.batch_size)

    model = GraphSAGE(
        hidden_feats=args.num_hidden,
        out_feats=data.num_classes,
        num_layers=args.num_layers,
        dropout=args.dropout,
    )
    # init with one sampled batch
    b0 = sampler.sample(csr, train_nid[: args.batch_size], np.random.default_rng(0), args.batch_size)
    x0 = jnp.take(x, b0.input_nodes, axis=0)
    params = jax.jit(model.init)(jax.random.PRNGKey(args.seed), b0.blocks, x0)["params"]
    tx = optax.adam(args.lr)
    opt = tx.init(params)

    @jax.jit
    def train_step(params, opt, key, blocks, input_nodes, seeds, seed_mask, x, y):
        batch_x = jnp.take(x, input_nodes, axis=0)
        batch_y = jnp.take(y, seeds, axis=0)

        def loss_fn(pp):
            logits = model.apply(
                {"params": pp}, blocks, batch_x, deterministic=False,
                rngs={"dropout": key},
            )
            return masked_softmax_ce(logits, batch_y, seed_mask), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        # train acc from the TRAINING forward's predictions (reference
        # ns-sage-dgl.py:166-169 compute_acc(batch_pred, ...) — a second
        # deterministic forward per step doubled the NS step cost)
        acc = masked_accuracy(logits, batch_y, seed_mask)
        return optax.apply_updates(params, updates), opt, loss, acc

    # --scan-steps: one dispatch per epoch — on-device sampling AND training
    # scanned over a (n_steps, b_pad) seed matrix (the only per-epoch H2D).
    # Same math as the step loop: sequential optimizer updates, fresh
    # per-step sample/dropout keys. Removes ~2 dispatches/step of host
    # latency (~190 steps/epoch on reddit).
    if not args.host_sampler:
        skel = dsampler.skeleton_blocks(args.batch_size)

        @jax.jit
        def train_epoch_scan(params, opt, key, seed_mat, mask_mat, x, y):
            def body(carry, step_in):
                params, opt, key = carry
                seeds, mask = step_in
                key, k_s, k_d = jax.random.split(key, 3)
                inp = dsampler.input_nodes(seeds, k_s)
                params, opt, loss, acc = train_step(
                    params, opt, k_d, skel, inp, seeds, mask, x, y)
                return (params, opt, key), (loss, acc)

            (params, opt, key), (losses, accs) = jax.lax.scan(
                body, (params, opt, key), (seed_mat, mask_mat))
            return params, opt, losses[-1], accs[-1]

    @jax.jit
    def full_forward(params, g, x):
        return model.apply({"params": params}, g, x, deterministic=True)

    def evaluate(params, nid):
        logits = full_forward(params, g_full, x)
        m = np.zeros(data.num_nodes, dtype=bool)
        m[nid] = True
        return float(masked_accuracy(logits, y, jnp.asarray(m)))

    def device_mem_mib():
        try:
            stats = jax.local_devices()[0].memory_stats() or {}
            return stats.get("bytes_in_use", 0) / 1e6
        except Exception:
            return 0.0

    key = jax.random.PRNGKey(args.seed)
    avg = 0.0
    iter_throughput = []
    for epoch in range(args.num_epochs):
        tic = time.time()
        tic_step = time.time()
        if args.scan_steps and not args.host_sampler:
            idx = loader_rng.permutation(train_nid)
            n_steps = (len(idx) + args.batch_size - 1) // args.batch_size
            seed_mat = np.zeros((n_steps, args.batch_size), np.int32)
            mask_mat = np.zeros((n_steps, args.batch_size), bool)
            for s in range(n_steps):
                part = idx[s * args.batch_size:(s + 1) * args.batch_size]
                seed_mat[s, : len(part)] = part
                mask_mat[s, : len(part)] = True
            key, sub = jax.random.split(key)
            params, opt, loss, acc = train_epoch_scan(
                params, opt, sub, jnp.asarray(seed_mat), jnp.asarray(mask_mat),
                x, y)
            loss_v, acc_v = float(loss), float(acc)
            toc = time.time()
            throughput = len(idx) / (toc - tic)
            print(
                "Epoch {:05d} | Step {:05d} | Loss {:.4f} | Train Acc {:.4f} | "
                "Speed (samples/sec) {:.4f} | GPU {:.1f} MiB".format(
                    epoch, n_steps - 1, loss_v, acc_v, throughput, device_mem_mib()))
            print("Epoch Time(s): {:.4f}".format(toc - tic))
            if epoch >= 5:
                avg += toc - tic
            if epoch % args.eval_every == 0 and epoch != 0:
                print("Eval Acc {:.4f}".format(evaluate(params, val_nid)))
                print("Test Acc: {:.4f}".format(evaluate(params, test_nid)))
            continue
        it = loader if args.host_sampler else device_loader()
        for step, mb in enumerate(it):
            key, sub = jax.random.split(key)
            params, opt, loss, acc = train_step(
                params, opt, sub, mb.blocks, mb.input_nodes, mb.seeds, mb.seed_mask, x, y
            )
            iter_throughput.append(args.batch_size / (time.time() - tic_step))
            if step % args.log_every == 0:
                # the ONLY per-step device sync is this logging readback
                print(
                    "Epoch {:05d} | Step {:05d} | Loss {:.4f} | Train Acc {:.4f} | "
                    "Speed (samples/sec) {:.4f} | GPU {:.1f} MiB".format(
                        epoch, step, float(loss), float(acc), float(np.mean(iter_throughput[3:]))
                        if len(iter_throughput) > 3 else 0.0, device_mem_mib(),
                    )
                )
            tic_step = time.time()
        jax.block_until_ready(loss)  # epoch timing counts in-flight steps
        toc = time.time()
        print("Epoch Time(s): {:.4f}".format(toc - tic))
        if epoch >= 5:
            avg += toc - tic
        if epoch % args.eval_every == 0 and epoch != 0:
            print("Eval Acc {:.4f}".format(evaluate(params, val_nid)))
            print("Test Acc: {:.4f}".format(evaluate(params, test_nid)))
    if args.num_epochs > 5:
        print("Avg epoch time: {}".format(avg / (args.num_epochs - 5)))


if __name__ == "__main__":
    main()
