"""Headline benchmark: full-graph GraphSAGE on reddit (one epoch of training).

Reference baseline: DGL 0.6.1 on one V100 — 0.3627 s/epoch
(``/root/reference/README.md:42``; PyG: 0.4037 s). Same workload semantics:
2-layer SAGE, mean aggregation, hidden 16, full-batch Adam step over
232 965 nodes / 11.6M edges / 602-d features (synthetic fallback data with
matched structure when the real dataset is absent — epoch time depends only
on the structure).

The timed loop syncs on the host once per epoch (``float(loss)``), as the
reference's timed loop does (``main_dgl_citation_sage.py:211-222``). The
primary metric is the UNHOISTED epoch, the full per-epoch work. The exact
layer-1 hoist (reference's ``use_pp`` trick: the aggregation of the constant
input features precomputed once) is reported as a secondary number.

Runs only on a GPU: it exits non-zero when JAX finds none.

Prints ONE JSON line:
  {"metric": "reddit_sage_epoch_time", "value": <s>, "unit": "s",
   "vs_baseline": <baseline/value>, "hoisted_s": <s>,
   "hoisted_vs_baseline": ..., "setup_s": ...,
   "device": {"platform": ..., "kind": ..., "count": ...}}
(vs_baseline > 1 == faster than DGL-V100)
"""

import argparse
import json
import os
import sys
import time

import numpy as np

BASELINE_S = 0.3627  # DGL V100, README.md:42
HIDDEN = 16  # reference reddit SAGE width (main_dgl_citation_sage.py:130-148)
LR = 1e-2


def sage_loss(model, params, key, g, x, y, mask, x_agg):
    """Masked mean cross-entropy of one training forward (dropout on)."""
    import jax

    logits = model.apply(
        {"params": params}, g, x, x_agg=x_agg, deterministic=False,
        rngs={"dropout": key},
    )
    logp = jax.nn.log_softmax(logits)
    ce = -jax.numpy.take_along_axis(logp, y[:, None], 1)[:, 0]
    m = mask.astype(ce.dtype)
    return jax.numpy.sum(ce * m) / jax.numpy.sum(m)


def make_train_step(model, tx):
    """The jitted full-graph Adam step ``(params, opt, key, g, x, y, mask,
    x_agg) -> (params, opt, loss)``; ``x_agg=None`` is the unhoisted step."""
    import jax
    import optax

    @jax.jit
    def step(params, opt, key, g, x, y, mask, x_agg):
        loss, grads = jax.value_and_grad(
            lambda p: sage_loss(model, p, key, g, x, y, mask, x_agg))(params)
        updates, opt = tx.update(grads, opt)
        return optax.apply_updates(params, updates), opt, loss

    return step


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=15, help="timed epochs per mode")
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--hoisted-only", action="store_true")
    parser.add_argument("--unhoisted-only", action="store_true")
    parser.add_argument("--dataset", type=str, default="reddit")
    parser.add_argument("--profile", type=str, default=None,
                        help="write a jax profiler trace of 3 unhoisted epochs here")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures on a GPU; JAX found {jax.default_backend()!r}")
    dev = jax.devices()[0]

    from dgl_jax.data import load_node_dataset
    from dgl_jax.models import GraphSAGE
    from dgl_jax.ops.spmm import gspmm_chunked

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "benchmarks"))
    from common import prepare_full_graph  # noqa: E402  (cached host prep)

    data = load_node_dataset(args.dataset)
    t_setup0 = time.time()
    g, features, labels, masks, _ = prepare_full_graph(args.dataset, data)
    t_setup = time.time() - t_setup0

    x = jnp.asarray(features)
    y = jnp.asarray(labels)
    mask = jnp.asarray(masks["train"])

    model = GraphSAGE(hidden_feats=HIDDEN, out_feats=data.num_classes, num_layers=2)
    tx = optax.adam(LR)
    step = make_train_step(model, tx)

    def measure(x_agg, profile_dir=None):
        params = model.init(jax.random.PRNGKey(0), g, x, x_agg=x_agg)["params"]
        opt = tx.init(params)
        key = jax.random.PRNGKey(0)
        lv = np.nan
        for _ in range(args.warmup):
            key, sub = jax.random.split(key)
            params, opt, l = step(params, opt, sub, g, x, y, mask, x_agg)
            lv = float(l)
        if profile_dir:
            with jax.profiler.trace(profile_dir):
                for _ in range(3):
                    key, sub = jax.random.split(key)
                    params, opt, l = step(params, opt, sub, g, x, y, mask, x_agg)
                    lv = float(l)
            print(f"# profiler trace written to {profile_dir}", file=sys.stderr)
        times = []
        for _ in range(args.epochs):
            t0 = time.perf_counter()
            key, sub = jax.random.split(key)
            params, opt, l = step(params, opt, sub, g, x, y, mask, x_agg)
            lv = float(l)  # one host sync per epoch (parity with loss.item())
            times.append(time.perf_counter() - t0)
        if not np.isfinite(lv):
            raise FloatingPointError(f"non-finite loss {lv}")
        return float(np.mean(times)), times, lv  # the reference reports the mean

    dt_unhoisted = dt_hoisted = None
    times_u = times_h = []
    lv = np.nan
    if not args.hoisted_only:
        dt_unhoisted, times_u, lv = measure(None, profile_dir=args.profile)
    t_pre = 0.0
    if not args.unhoisted_only:
        t0 = time.time()
        x_agg = gspmm_chunked(g, "copy_u", "mean", x)
        jax.block_until_ready(x_agg)
        t_pre = time.time() - t0
        dt_hoisted, times_h, lv = measure(x_agg)

    primary = dt_unhoisted if dt_unhoisted is not None else dt_hoisted
    out = {
        "metric": "reddit_sage_epoch_time",
        "value": primary,
        "unit": "s",
        "vs_baseline": BASELINE_S / primary,
    }
    if dt_hoisted is not None and dt_unhoisted is not None:
        out["hoisted_s"] = dt_hoisted
        out["hoisted_vs_baseline"] = BASELINE_S / dt_hoisted
    out["setup_s"] = t_setup
    out["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(out))
    print(
        f"# precompute_setup_s={t_pre:.2f} final_loss={lv:.4f} "
        f"baseline_dgl_v100_s={BASELINE_S} synthetic_data={data.synthetic} "
        f"unhoisted_epochs_s={times_u} hoisted_epochs_s={times_h}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
