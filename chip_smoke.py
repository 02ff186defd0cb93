"""Bring-up check on the GPU: full-graph GraphSAGE on reddit, end to end.

Usage::

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # the multi-device paths on four GPUs

One card, in order (any failure exits non-zero):

1. Device: requires JAX's GPU backend; prints the device and the card's
   name and power limit (``nvidia-smi``).
2. Ops at reddit size (synthetic reddit: 232,965 nodes, 11,606,919 edges,
   602-d features, 41 classes) against a plain float32 ``jax.numpy``
   composition run on the host's CPU backend in the same process:
   ``gspmm`` copy_u sum/mean and u_mul_e sum at widths 16 and 41, one 64-wide
   chunk of the layer-1 precompute (``gspmm_chunked``), ``gsddmm`` u_dot_v,
   and ``edge_softmax`` forward and gradient at 8 heads (exact shift, a
   tight bound, and a loose bound that takes the exact fallback).
3. Main path: the reddit SAGE train step of ``bench.py`` (2 layers, hidden
   16, mean aggregation, Adam), unhoisted and hoisted (layer-1 aggregation
   precomputed by ``gspmm_chunked``): the first step's loss and gradients
   against the same step on the CPU backend, then a few steps whose loss
   must be finite and fall; the step's ``memory_analysis()`` and the
   device's peak memory.

With ``--four-cards`` only the multi-device paths run, each beside the one-
card computation it must match: edge-partitioned reddit SAGE on a ``(1, 4)``
mesh (``main_sage.py --shard 4``), the data-parallel sampled step on a
``(4, 1)`` mesh (``parallel/dp.py``), and the halo kernels of
``__graft_entry__.dryrun_multichip``.

Comparisons run under ``jax.default_matmul_precision("highest")`` (an f32
matmul on this GPU may otherwise run in TF32). The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "benchmarks"))
sys.path.insert(0, os.path.join(HERE, "benchmarks", "node_classification"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import bench  # noqa: E402
import dgl_jax  # noqa: E402
from dgl_jax.data import load_node_dataset  # noqa: E402
from dgl_jax.models import GraphSAGE  # noqa: E402
from dgl_jax.ops import edge_softmax, gsddmm, gspmm  # noqa: E402
from dgl_jax.ops.spmm import gspmm_chunked  # noqa: E402

# Sums over a destination's in-edges are taken in another order on the GPU
# (sorted scatter-add with atomics) than on the CPU, so f32 results differ
# by reassociation: a few ulps of the row norm per row, times the depth of
# the reduction. 1e-4 of the row norm bounds that with room; a wrong
# aggregation is off by O(1).
TOL_SUM = 1e-4
# The edge-softmax gradient alpha * (ct - sum alpha ct) can cancel to ~0,
# so its error is measured against ||alpha * ct||, the size of its terms;
# the subtraction still amplifies reassociation error, so the bound is ten
# times looser.
TOL_CANCEL = 1e-3
REDDIT = "reddit"
STEPS = 5


def require_gpu(count: int = 1):
    """The GPU devices, or exit: this check never falls back to the CPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX's backend is {backend!r}")
    devices = jax.devices()
    if len(devices) < count:
        raise SystemExit(f"chip_smoke needs {count} GPUs; JAX sees {len(devices)}")
    return devices


def card_lines() -> list:
    """``nvidia-smi``'s name and power limit of each card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def rel_err(out, ref, scale=None) -> float:
    """Max over rows of ||out_row - ref_row|| / ||ref_row|| (or / ``scale``,
    one value per row, where the row's own norm is no measure of its
    error). Rows whose denominator is below 1e-3 of the median (zero
    in-degree rows, near-cancelling sums) are measured against that floor."""
    out = np.asarray(out, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    den = np.linalg.norm(ref, axis=1) if scale is None else np.asarray(scale, np.float64)
    pos = den[den > 0]
    floor = 1e-3 * float(np.median(pos)) if len(pos) else 1.0
    return float(np.max(np.linalg.norm(out - ref, axis=1) / np.maximum(den, floor)))


class Checks:
    """Collects comparisons; ``raise_if_failed`` ends the phase on any miss."""

    def __init__(self, phase: str):
        self.phase, self.failed = phase, []

    def add(self, name: str, err: float, tol: float, reason: str,
            measure: str = "row norm") -> None:
        ok = bool(np.isfinite(err)) and err <= tol
        print(f"  {'ok  ' if ok else 'FAIL'} {name}: max err / {measure} "
              f"{err:.3e} (tol {tol:.0e}: {reason})", flush=True)
        if not ok:
            self.failed.append(name)

    def require(self, name: str, cond: bool, detail: str) -> None:
        print(f"  {'ok  ' if cond else 'FAIL'} {name}: {detail}", flush=True)
        if not cond:
            self.failed.append(name)

    def raise_if_failed(self) -> None:
        if self.failed:
            raise SystemExit(f"{self.phase}: failed {self.failed}")


# -- plain float32 references (input edge order, no Graph machinery) -------


def _ref_sum(msg, dst, n):
    return jax.ops.segment_sum(msg, dst, num_segments=n)


def _ref_copy_u(x, src, dst, n, mean):
    s = _ref_sum(x[src], dst, n)
    if mean:
        deg = _ref_sum(jnp.ones(dst.shape, x.dtype), dst, n)
        s = s / jnp.maximum(deg, 1.0)[:, None]
    return s


def _ref_u_mul_e(x, w, src, dst, n):
    return _ref_sum(x[src] * w, dst, n)


def _ref_u_dot_v(u, v, src, dst):
    return jnp.sum(u[src] * v[dst], axis=-1, keepdims=True)


def _ref_edge_softmax(z, dst, n):
    m = jax.ops.segment_max(z, dst, num_segments=n)
    ez = jnp.exp(z - m[dst])
    return ez / _ref_sum(ez, dst, n)[dst]


def check_ops(src, dst, n, x, dev, ref_dev, widths=(16, 41), heads=8, seed=0):
    """Compare the ops on ``dev`` with the plain references on ``ref_dev``
    over the graph ``(src, dst)`` (input order) and node features ``x``
    (n, >= 64). Returns the ``Checks``."""
    checks = Checks("ops")
    rng = np.random.default_rng(seed)
    e = len(src)
    with jax.default_device(dev):
        g = dgl_jax.from_edges(src, dst, n)
    # canonical slot i holds input edge eid[i]; pos maps input -> canonical
    eid = np.asarray(g.eid)[:e]
    pos = np.empty(e, np.int64)
    pos[eid] = np.arange(e)

    def on(d, *arrays):
        return [jax.device_put(a, d) for a in arrays]

    rsrc, rdst = on(ref_dev, np.asarray(src, np.int32), np.asarray(dst, np.int32))
    # graphs and index arrays are jit ARGUMENTS throughout: closed-over
    # arrays would be baked into the program as constants

    permute = jax.jit(lambda g, a: g.permute_edata(a))

    def canon(a):  # input-order edge data -> canonical order on dev
        return permute(g, jax.device_put(a, dev))

    spmm = jax.jit(lambda g, x, w, op, r: gspmm(g, op, r, x=x, e=w),
                   static_argnums=(3, 4))
    ref_copy_u = jax.jit(_ref_copy_u, static_argnums=(3, 4))
    for d in widths:
        xd = np.ascontiguousarray(x[:, :d])
        w = rng.standard_normal((e, 1)).astype(np.float32)
        (gx,) = on(dev, xd)
        rx, rw = on(ref_dev, xd, w)
        for reduce in ("sum", "mean"):
            out = spmm(g, gx, None, "copy_u", reduce)
            ref = ref_copy_u(rx, rsrc, rdst, n, reduce == "mean")
            checks.add(f"gspmm copy_u {reduce} d={d}", rel_err(out, ref),
                       TOL_SUM, "f32 sum reassociation")
        out = spmm(g, gx, canon(w), "mul", "sum")
        ref = jax.jit(_ref_u_mul_e, static_argnums=(4,))(rx, rw, rsrc, rdst, n)
        checks.add(f"gspmm u_mul_e sum d={d}", rel_err(out, ref), TOL_SUM,
                   "f32 sum reassociation")

    x64 = np.ascontiguousarray(x[:, :64])
    out = gspmm_chunked(g, "copy_u", "mean", jax.device_put(x64, dev), chunk=64)
    ref = ref_copy_u(jax.device_put(x64, ref_dev), rsrc, rdst, n, True)
    checks.add("gspmm_chunked copy_u mean d=64", rel_err(out, ref), TOL_SUM,
               "f32 sum reassociation")

    u = rng.standard_normal((n, 16)).astype(np.float32)
    v = rng.standard_normal((n, 16)).astype(np.float32)
    out = jax.jit(lambda g, u, v: gsddmm(g, "dot", u, v))(g, *on(dev, u, v))
    ref = jax.jit(_ref_u_dot_v)(*on(ref_dev, u, v), rsrc, rdst)
    # a dot product can cancel to ~0, so its error is measured against
    # |u_src| * |v_dst|, the Cauchy-Schwarz bound of its magnitude
    scale = (np.linalg.norm(u, axis=1)[np.asarray(src)]
             * np.linalg.norm(v, axis=1)[np.asarray(dst)])
    checks.add("gsddmm u_dot_v d=16", rel_err(np.asarray(out)[pos], ref, scale),
               TOL_SUM, "16-term dot in another order, with FMA",
               measure="|u_src| |v_dst|")

    z = rng.standard_normal((e, heads)).astype(np.float32)
    ct = rng.standard_normal((e, heads)).astype(np.float32)
    gz, gct = canon(z), canon(ct)
    rz, rct = on(ref_dev, z, ct)
    ref_fwd = jax.jit(_ref_edge_softmax, static_argnums=(2,))(rz, rdst, n)
    ref_grad = jax.jit(jax.grad(
        lambda z, ct, dst: jnp.sum(_ref_edge_softmax(z, dst, n) * ct)))(rz, rct, rdst)
    true_max = jax.jit(jax.ops.segment_max, static_argnums=(2,))(rz, rdst, n)
    true_max = np.where(np.isfinite(true_max), true_max, 0.0).astype(np.float32)
    fwd = jax.jit(lambda g, z, b: edge_softmax(g, z, dst_bound=b))
    grad = jax.jit(jax.grad(
        lambda z, g, ct, b: jnp.sum(edge_softmax(g, z, dst_bound=b) * ct)))
    grad_scale = np.linalg.norm(np.asarray(ref_fwd) * ct, axis=1)
    # no bound: exact segment max; +1: the bound-shift path; +200: every
    # denominator underflows and the lax.cond fallback reruns the exact path
    for label, slack in (("exact", None), ("bound+1", 1.0), ("bound+200", 200.0)):
        bound = None if slack is None else jax.device_put(true_max + slack, dev)
        out = np.asarray(fwd(g, gz, bound))[:e][pos]
        checks.add(f"edge_softmax fwd H={heads} {label}", rel_err(out, ref_fwd),
                   TOL_SUM, "f32 exp-sum reassociation")
        gout = np.asarray(grad(gz, g, gct, bound))[:e][pos]
        checks.add(f"edge_softmax grad H={heads} {label}",
                   rel_err(gout, ref_grad, grad_scale), TOL_CANCEL,
                   "cancellation in alpha * (ct - sum alpha ct)",
                   measure="|alpha ct|")
    return checks


# -- phases ------------------------------------------------------------------


def phase_device(count: int):
    devices = require_gpu(count)
    d = devices[0]
    print(f"[device] platform={d.platform} kind={d.device_kind} count={len(devices)}")
    cards = card_lines()
    for line in cards:
        print(f"[device] nvidia-smi: {line}")
    return devices, cards


def load_reddit(scale: float = 1.0):
    t0 = time.time()
    data = load_node_dataset(REDDIT, scale=scale)
    print(f"[data] reddit: {data.num_nodes} nodes, {len(data.src)} edges, "
          f"{data.features.shape[1]}-d features, {data.num_classes} classes, "
          f"synthetic={data.synthetic} ({time.time() - t0:.1f} s)", flush=True)
    return data


def phase_ops(data, dev, cpu):
    print("[ops] reddit-size ops vs plain f32 jnp on the CPU backend", flush=True)
    t0 = time.time()
    with jax.default_matmul_precision("highest"):
        checks = check_ops(np.asarray(data.src), np.asarray(data.dst),
                           data.num_nodes, np.asarray(data.features), dev, cpu)
    print(f"[ops] done in {time.time() - t0:.1f} s", flush=True)
    checks.raise_if_failed()


def _tree_rel_err(a, b) -> float:
    errs = [np.linalg.norm(np.asarray(x, np.float64) - np.asarray(y, np.float64))
            / max(np.linalg.norm(np.asarray(y, np.float64)), 1e-30)
            for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b))]
    return float(max(errs))


def phase_main(data, dev, cpu, card):
    print("[main] reddit GraphSAGE (2 layers, hidden 16, mean, Adam) via bench.py",
          flush=True)
    checks = Checks("main")
    with jax.default_device(dev):
        g = dgl_jax.from_edges(data.src, data.dst, data.num_nodes)
        x = jnp.asarray(data.features)
        y = jnp.asarray(data.labels)
        mask = jnp.asarray(data.train_mask)
    model = GraphSAGE(hidden_feats=bench.HIDDEN, out_feats=data.num_classes,
                      num_layers=2)
    tx = optax.adam(bench.LR)
    step = bench.make_train_step(model, tx)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, key, g, x, y, m, xa: bench.sage_loss(model, p, key, g, x, y, m, xa)))

    t0 = time.time()
    x_agg = gspmm_chunked(g, "copy_u", "mean", x)
    jax.block_until_ready(x_agg)
    print(f"[main] hoisted precompute gspmm_chunked 602-d: {time.time() - t0:.2f} s",
          flush=True)
    checks.require("precompute finite", bool(jnp.all(jnp.isfinite(x_agg))),
                   f"x_agg {x_agg.shape}")

    for label, xa in (("unhoisted", None), ("hoisted", x_agg)):
        key = jax.random.PRNGKey(0)
        params = jax.jit(model.init)(key, g, x, x_agg=xa)["params"]
        # first step against the CPU backend, both at full f32 precision
        with jax.default_matmul_precision("highest"):
            l_dev, gr_dev = value_and_grad(params, key, g, x, y, mask, xa)
            cpu_args = jax.device_put((params, key, g, x, y, mask, xa), cpu)
            l_cpu, gr_cpu = value_and_grad(*cpu_args)
        l_dev, l_cpu = float(l_dev), float(l_cpu)
        checks.add(f"{label} first-step loss vs CPU ({l_dev:.6f} vs {l_cpu:.6f})",
                   abs(l_dev - l_cpu) / abs(l_cpu), TOL_SUM, "f32 reassociation")
        checks.add(f"{label} first-step grads vs CPU", _tree_rel_err(gr_dev, gr_cpu),
                   TOL_SUM, "f32 reassociation; norm over each leaf")

        compiled = step.lower(params, tx.init(params), key, g, x, y, mask, xa).compile()
        print(f"[main] {label} step memory_analysis: {compiled.memory_analysis()}")
        opt = tx.init(params)
        losses, times = [], []
        for _ in range(STEPS):
            key, sub = jax.random.split(key)
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, sub, g, x, y, mask, xa)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
        checks.require(f"{label} loss finite and falling",
                       bool(np.all(np.isfinite(losses))) and losses[-1] < losses[0],
                       f"losses {[round(v, 5) for v in losses]}")
        print(f"[main] {label} smoke step times on {card} (first includes "
              f"compile): {[round(t, 5) for t in times]} s")
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    print(f"[main] peak_bytes_in_use={peak}"
          + (f" ({peak / 2**30:.2f} GiB)" if peak else " (not reported)"))
    checks.raise_if_failed()


def phase_four_cards(devices, card, data):
    """Edge-partitioned SAGE on (1, 4), data-parallel NS step on (4, 1), and
    the halo kernels, each against its one-card computation."""
    import main_sage
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dgl_jax.parallel import (
        device_mesh, halo_sage_init, make_dp_train_step, stack_minibatches)
    from dgl_jax.sampling import CSRGraph, MultiLayerNeighborSampler

    import __graft_entry__

    checks = Checks("four-cards")
    n, c = data.num_nodes, data.num_classes

    # (1, 4): main_sage --shard 4 with dropout off, so the first-step loss
    # is deterministic; the one-card loss is the unsharded GraphSAGE model
    # carrying the same weights
    cfg = dict(main_sage.DATASET_CFG[REDDIT], dropout=0.0)
    s = main_sage.shard_setup(4, cfg, data)
    print(f"[four-cards] (1, 4) mesh: {s['mesh']}", flush=True)
    hp = halo_sage_init(jax.random.PRNGKey(0), data.features.shape[1],
                        cfg["hidden"], c, cfg["layers"])
    rep = NamedSharding(s["mesh"], P())
    params4 = jax.device_put(hp, rep)
    opt4 = jax.device_put(s["tx"].init(hp), rep)
    model = GraphSAGE(hidden_feats=cfg["hidden"], out_feats=c,
                      num_layers=cfg["layers"], dropout=0.0)
    params1 = {f"conv_{i}": {"fc_self": {"kernel": lp["w_self"]},
                             "fc_neigh": {"kernel": lp["w_neigh"]},
                             "fc_neigh_bias": lp["bias"]}
               for i, lp in enumerate(hp)}
    with jax.default_device(devices[0]):
        g1 = dgl_jax.from_edges(data.src, data.dst, n)
        x1, y1 = jnp.asarray(data.features), jnp.asarray(data.labels)
        m1 = jnp.asarray(data.train_mask)

    @jax.jit
    def loss1(p, g, x, y, m):
        logits = model.apply({"params": p}, g, x)
        ce = -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1)[:, 0]
        w = m.astype(ce.dtype)
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)

    key = jax.random.PRNGKey(1)
    losses, times = [], []
    with jax.default_matmul_precision("highest"):
        l1 = float(loss1(jax.device_put(params1, devices[0]), g1, x1, y1, m1))
        for _ in range(STEPS):
            key, sub = jax.random.split(key)
            t0 = time.perf_counter()
            params4, opt4, loss = s["train_step"](
                params4, opt4, sub, s["bs"], s["x"], s["y"], s["masks"]["train"])
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
    checks.add(f"--shard 4 first-step loss vs one card ({losses[0]:.6f} vs {l1:.6f})",
               abs(losses[0] - l1) / abs(l1), TOL_SUM, "f32 reassociation")
    checks.require("--shard 4 loss finite and falling",
                   bool(np.all(np.isfinite(losses))) and losses[-1] < losses[0],
                   f"losses {[round(v, 5) for v in losses]}")
    print(f"[four-cards] --shard 4 smoke step times on {card} (first includes "
          f"compile): {[round(t, 5) for t in times]} s")

    # (4, 1): one sampled minibatch per card, gradients pmean'd; the loss
    # must equal the mean of the four per-minibatch losses on one card
    mesh_dp = device_mesh((4, 1), ("data", "graph"), devices=devices[:4])
    print(f"[four-cards] (4, 1) mesh: {mesh_dp}", flush=True)
    csr = CSRGraph.from_edges(data.src, data.dst, n)
    sampler = MultiLayerNeighborSampler([10, 25])
    rng = np.random.default_rng(0)
    train_ids = np.flatnonzero(data.train_mask)
    batch = min(1000, len(train_ids) // 4)  # ns_sage.py's batch size
    mbs = [sampler.sample(csr, rng.choice(train_ids, batch, replace=False), rng, batch)
           for _ in range(4)]
    dp_model = GraphSAGE(hidden_feats=16, out_feats=c, num_layers=2, dropout=0.0)
    with jax.default_device(devices[0]):
        dp_params = dp_model.init(jax.random.PRNGKey(2), mbs[0].blocks,
                                  jnp.take(x1, mbs[0].input_nodes, axis=0))["params"]

    def dp_loss(p, mb, x, y):
        logits = dp_model.apply({"params": p}, mb.blocks,
                                jnp.take(x, mb.input_nodes, axis=0))
        by = jnp.take(y, mb.seeds, axis=0)
        ce = -jnp.take_along_axis(jax.nn.log_softmax(logits), by[:, None], 1)[:, 0]
        w = mb.seed_mask.astype(ce.dtype)
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)

    dp_tx = optax.sgd(0.1)
    dp_step = make_dp_train_step(dp_loss, dp_tx, mesh_dp)
    rep_dp = NamedSharding(mesh_dp, P())
    with jax.default_matmul_precision("highest"):
        one = float(np.mean([float(jax.jit(dp_loss)(dp_params, mb, x1, y1))
                             for mb in mbs]))
        _, _, l4 = dp_step(jax.device_put(dp_params, rep_dp),
                           jax.device_put(dp_tx.init(dp_params), rep_dp),
                           stack_minibatches(mbs),
                           jax.device_put(x1, rep_dp), jax.device_put(y1, rep_dp))
    l4 = float(l4)
    checks.add(f"(4, 1) data-parallel loss vs one card ({l4:.6f} vs {one:.6f})",
               abs(l4 - one) / abs(one), TOL_SUM, "f32 reassociation")

    # halo kernels (all_gather, boundary all_to_all, sharded GAT and RGCN,
    # data-parallel step) on toy shapes; each asserts finite results
    __graft_entry__.dryrun_multichip(4)
    checks.require("halo kernels dryrun_multichip(4)", True, "completed")
    checks.raise_if_failed()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the multi-device paths, on four GPUs")
    args = parser.parse_args()
    count = 4 if args.four_cards else 1
    devices, cards = phase_device(count)
    card = "; ".join(sorted(set(cards)))
    if args.four_cards:
        phase_four_cards(devices, card, load_reddit())
    else:
        cpu = jax.devices("cpu")[0]
        data = load_reddit()
        phase_ops(data, devices[0], cpu)
        phase_main(data, devices[0], cpu, card)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
