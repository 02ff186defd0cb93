"""SpMM / SDDMM kernel microbenchmarks (reference L0 tier:
``kernel/dgl-new.py`` + ``kernel/utils.py``).

Same protocol: sweep feature sizes 2^0..2^7 (or ``--widths``), 10 reps with
2 cold-start calls skipped (``dgl-new.py:8,18-23``), per-size OOM caught
(``:26-27``), datasets reddit / ogbn-arxiv / ogbn-proteins
(``utils.py:50-61``), binary-op × reduce-op axes from the CLI (``:48-58``).

Each op is timed on the host clock around back-to-back calls that end in
``block_until_ready``. ``--backward`` adds the gradient of the SpMM with
respect to the node features: the transpose SpMM over the reverse graph
(the SpMM is linear in ``x``, so XLA drops the unused forward). The roofline
share is the op's least memory traffic (features read once, edge indices,
output written once) over the device's published memory bandwidth
(``PEAK_HBM_BYTES_PER_S``), and over the bandwidth a plain copy reaches on
the same device in the same run. A device missing from the table is an
error: its roofline cannot be stated.
"""

import argparse
import csv
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/kernel/", 1)[0])

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dgl_jax  # noqa: E402
from dgl_jax.data import load_node_dataset  # noqa: E402
from dgl_jax.ops import gsddmm, gspmm  # noqa: E402
from dgl_jax.train.timing import time_fn  # noqa: E402

N_REPEATS = 10
N_COLD_START = 2
FEAT_SIZES = [2**x for x in range(8)]

# Published memory bandwidth by jax device_kind. Source: NVIDIA H100 Tensor
# Core GPU datasheet, SXM5 80 GB part (3.35 TB/s HBM3), rated at 700 W; a
# card capped below 700 W may not reach it.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_hbm_bytes_per_s(device_kind: str) -> float:
    """Published memory bandwidth of ``device_kind``; unknown kinds raise."""
    try:
        return PEAK_HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind {device_kind!r}; "
            "add it to PEAK_HBM_BYTES_PER_S with its source") from None


def min_bytes(kind: str, n_src: int, n_dst: int, n_edges: int, n_hid: int,
              itemsize: int = 4) -> int:
    """Least memory traffic of one op: node features read once, edge index
    stream, output written once."""
    feat = n_hid * itemsize
    if kind == "spmm":  # read x once + src and dst ids + write out
        return n_src * feat + n_edges * 8 + n_dst * feat
    if kind == "spmm_bwd":  # the transpose SpMM: read d_out, write d_x
        return n_dst * feat + n_edges * 8 + n_src * feat
    if kind == "sddmm":  # read u,v once + 2 edge ids + write per-edge out
        return (n_src + n_dst) * feat + n_edges * 8 + n_edges * feat
    if kind == "scatter":  # materialized (E, D) message: gather write+read
        return n_src * feat + n_edges * 8 + 2 * n_edges * feat + n_dst * feat
    raise ValueError(f"unknown op kind {kind!r}")


def copy_bandwidth(n_bytes: int = 1 << 30) -> float:
    """Bytes/s a plain elementwise copy (read + write) reaches on the
    default device: the practical ceiling for a memory-bound op."""
    x = jnp.ones((n_bytes // 4,), jnp.float32)
    f = jax.jit(lambda a: a * 2.0)
    return 2 * n_bytes / time_fn(f, x, reps=N_REPEATS, warmup=N_COLD_START)


class Recorder:
    """Prints each measurement with its roofline shares; appends to a CSV."""

    def __init__(self, csv_path, peak, copy_bps):
        self.csv_path, self.peak, self.copy_bps = csv_path, peak, copy_bps

    def add(self, dataset, kind, op, graph, n_hid, seconds):
        b = min_bytes(kind, graph.num_src_nodes, graph.num_dst_nodes,
                      graph.num_edges, n_hid)
        share = b / (self.peak * seconds)
        copy_share = b / (self.copy_bps * seconds)
        print(f"{kind} {op} hidden size: {n_hid}, avg time: {seconds:.6g} s, "
              f"roofline {100 * share:.1f}% of peak, "
              f"{100 * copy_share:.1f}% of copy bandwidth")
        if self.csv_path:
            new = not os.path.exists(self.csv_path)
            with open(self.csv_path, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["device", "dataset", "kind", "op", "hidden",
                                "seconds", "min_bytes", "roofline_share",
                                "copy_share"])
                w.writerow([jax.devices()[0].device_kind, dataset, kind, op,
                            n_hid, seconds, b, share, copy_share])


def _graph(name, scale):
    data = load_node_dataset(name, scale=scale)
    return dgl_jax.from_edges(data.src, data.dst, data.num_nodes)


def bench_spmm(rec, name, graph, widths, binary_op, reduce_op, backward):
    print("SPMM\n----")
    rng = np.random.default_rng(0)
    for n_hid in widths:
        try:
            x = (jnp.asarray(rng.standard_normal(
                (graph.num_src_nodes, n_hid)).astype(np.float32))
                 if binary_op != "copy_rhs" else None)
            e = (jnp.asarray(rng.standard_normal(
                (graph.num_edges_padded, n_hid)).astype(np.float32))
                 if binary_op != "copy_lhs" else None)
            # the graph is a jit argument: closed over, its arrays would be
            # baked into the program as constants
            fwd = jax.jit(lambda g, x, e: gspmm(g, binary_op, reduce_op, x=x, e=e))
            t = time_fn(fwd, graph, x, e, reps=N_REPEATS, warmup=N_COLD_START)
            rec.add(name, "spmm", f"{binary_op}.{reduce_op}", graph, n_hid, t)
            if backward and x is not None:
                ct = jnp.asarray(rng.standard_normal(
                    (graph.num_dst_nodes, n_hid)).astype(np.float32))
                grad = jax.jit(jax.grad(lambda x, g, e, ct: jnp.vdot(
                    gspmm(g, binary_op, reduce_op, x=x, e=e), ct)))
                t = time_fn(grad, x, graph, e, ct, reps=N_REPEATS,
                            warmup=N_COLD_START)
                rec.add(name, "spmm_bwd", f"{binary_op}.{reduce_op}",
                        graph, n_hid, t)
        except Exception as exc:  # OOM etc → report and continue (dgl-new.py:26)
            print(f"hidden size: {n_hid}, OOM/err: {type(exc).__name__}")


def bench_sddmm(rec, name, graph, widths, binary_op):
    print("SDDMM\n----")
    rng = np.random.default_rng(0)
    for n_hid in widths:
        try:
            u = jnp.asarray(rng.standard_normal((graph.num_src_nodes, n_hid)).astype(np.float32))
            v = jnp.asarray(rng.standard_normal((graph.num_dst_nodes, n_hid)).astype(np.float32))
            f = jax.jit(lambda g, u, v: gsddmm(g, binary_op, u, v, mask_padding=False))
            rec.add(name, "sddmm", binary_op, graph, n_hid,
                    time_fn(f, graph, u, v, reps=N_REPEATS, warmup=N_COLD_START))
        except Exception as exc:
            print(f"hidden size: {n_hid}, OOM/err: {type(exc).__name__}")


def bench_scatter(rec, name, graph, widths, reduce_op):
    """PyG-twin tier (reference K2, ``kernel/pyg-new.py``): the same
    aggregation expressed through the USER-LEVEL scatter API — an explicit
    edge gather followed by ``ops.segment_{sum,mean,max}`` — instead of the
    fused ``gspmm``. The gap between this sweep and the SPMM sweep is the
    fusion benefit the reference measures DGL-vs-PyG."""
    from dgl_jax.ops import segment

    print("SCATTER (segment user ops)\n----")
    seg_fn = {"sum": segment.segment_sum, "mean": segment.segment_mean,
              "max": segment.segment_max}[reduce_op]
    src, dst, n_dst = graph.src, graph.dst, graph.num_dst_nodes
    rng = np.random.default_rng(0)
    for n_hid in widths:
        try:
            x = jnp.asarray(rng.standard_normal((graph.num_src_nodes, n_hid)).astype(np.float32))
            f = jax.jit(lambda x, src, dst: seg_fn(x[src], dst, n_dst))
            rec.add(name, "scatter", f"gather.segment_{reduce_op}", graph, n_hid,
                    time_fn(f, x, src, dst, reps=N_REPEATS, warmup=N_COLD_START))
        except Exception as exc:
            print(f"hidden size: {n_hid}, OOM/err: {type(exc).__name__}")


def main():
    parser = argparse.ArgumentParser("benchmark on g-spmm and g-sddmm (dgl_jax)")
    parser.add_argument("--spmm-binary", type=str, default="copy_lhs",
                        choices=["add", "sub", "mul", "div", "copy_lhs", "copy_rhs"])
    parser.add_argument("--spmm-reduce", type=str, default="sum",
                        choices=["sum", "mean", "max", "min"])
    parser.add_argument("--sddmm-binary", type=str, default="add",
                        choices=["add", "sub", "mul", "div", "dot"])
    parser.add_argument("--datasets", type=str, default="reddit,ogbn-arxiv,ogbn-proteins")
    parser.add_argument("--widths", type=str, default=None,
                        help="comma-separated feature sizes (default 1..128)")
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--skip-sddmm", action="store_true")
    parser.add_argument("--skip-spmm", action="store_true")
    parser.add_argument("--backward", action="store_true",
                        help="also time the SpMM backward (grad wrt x)")
    parser.add_argument("--scatter", action="store_true",
                        help="also sweep the user-level scatter API "
                             "(gather + segment_* — the PyG-twin tier)")
    parser.add_argument("--csv", type=str, default=None,
                        help="append one row per measurement to this CSV")
    args = parser.parse_args()
    print(args)
    dev = jax.devices()[0]
    peak = peak_hbm_bytes_per_s(dev.device_kind)
    copy_bps = copy_bandwidth()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"published peak {peak / 1e12:.2f} TB/s; plain copy reaches "
          f"{copy_bps / 1e12:.3f} TB/s")
    rec = Recorder(args.csv, peak, copy_bps)
    widths = ([int(w) for w in args.widths.split(",")] if args.widths
              else FEAT_SIZES)
    for name in args.datasets.split(","):
        print("benchmarking on:", name)
        graph = _graph(name, args.scale)
        if not args.skip_spmm:
            bench_spmm(rec, name, graph, widths, args.spmm_binary,
                       args.spmm_reduce, args.backward)
        if not args.skip_sddmm:
            bench_sddmm(rec, name, graph, widths, args.sddmm_binary)
        if args.scatter:
            reduce = args.spmm_reduce if args.spmm_reduce != "min" else "max"
            bench_scatter(rec, name, graph, widths, reduce)


if __name__ == "__main__":
    main()
