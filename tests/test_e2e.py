"""End-to-end accuracy gates (the reference's QA model, SURVEY §4: golden
numbers + statistical tolerance). Real-data gates need the real datasets;
these gates assert the full train stack *learns* on the planted synthetic
signal, which catches broken gradients/masks/aggregation wiring."""

import subprocess
import sys
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, timeout=900):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, script), *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _final_test(out):
    import re

    m = re.findall(r"Final Test: ([0-9.]+)", out)
    assert m, out[-2000:]
    return float(m[-1])


def test_cora_sage_accuracy_gate():
    out = _run("benchmarks/node_classification/main_sage.py",
               "--dataset", "cora", "--epochs", "30", "--runs", "1", "--eval")
    assert _final_test(out) > 75.0  # synthetic cora, 140-node train set


def test_cora_sage_precompute_matches_exactly():
    a = _run("benchmarks/node_classification/main_sage.py",
             "--dataset", "cora", "--epochs", "10", "--runs", "1", "--eval")
    b = _run("benchmarks/node_classification/main_sage.py",
             "--dataset", "cora", "--epochs", "10", "--runs", "1", "--eval",
             "--no-precompute")
    assert abs(_final_test(a) - _final_test(b)) < 1e-6


def test_ns_sage_learns():
    out = _run("benchmarks/sampling/ns_sage.py",
               "--dataset", "cora", "--num-epochs", "8", "--batch-size", "64",
               "--fan-out", "5,5", "--eval-every", "7")
    import re

    accs = re.findall(r"Test Acc: ([0-9.]+)", out)
    assert accs and float(accs[-1]) > 0.7


# ---------------------------------------------------------------------------
# Hardened structure-required gates.
#
# DGL_JAX_SYNTH_STRUCTURAL=1 switches the synthetic fallback to a
# construction where the label is a function of the IN-NEIGHBOR-MEAN latent
# and the node's own features are independent of it: a features-only model
# (or any broken aggregation) scores near chance (1/41 ≈ 2.4% here), while
# one correct mean-aggregation step makes the label linearly decodable.
# DGL_JAX_FAULT_ZERO_AGG=1 injects a broken gspmm (zeroed aggregation); the
# same three gates must then FAIL.
# ---------------------------------------------------------------------------

_STRUCT = {"DGL_JAX_SYNTH_STRUCTURAL": "1"}
_BROKEN = {"DGL_JAX_SYNTH_STRUCTURAL": "1", "DGL_JAX_FAULT_ZERO_AGG": "1"}


def _run_env(extra_env, script, *args, timeout=900):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra_env)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, script), *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_structural_gate_sage():
    args = ("--dataset", "reddit", "--scale", "0.01", "--epochs", "25",
            "--runs", "1", "--eval")
    ok = _final_test(_run_env(_STRUCT, "benchmarks/node_classification/main_sage.py", *args))
    assert ok > 40.0, f"correct aggregation should clear 40%, got {ok}"
    broken = _final_test(_run_env(_BROKEN, "benchmarks/node_classification/main_sage.py", *args))
    assert broken < 25.0, f"broken aggregation must fail this gate, got {broken}"


def test_structural_gate_gat():
    # GAT learns the neighbor-MEAN signal slower than SAGE (attention must
    # first converge toward uniform weights), so this gate needs more
    # epochs; calibrated correct=26.7 / broken=8.6 at 80 epochs
    args = ("--dataset", "reddit", "--scale", "0.01", "--epochs", "80",
            "--runs", "1", "--eval")
    ok = _final_test(_run_env(_STRUCT, "benchmarks/node_classification/main_gat.py", *args))
    assert ok > 20.0, f"correct attention aggregation should clear 20%, got {ok}"
    broken = _final_test(_run_env(_BROKEN, "benchmarks/node_classification/main_gat.py", *args))
    assert broken < 15.0, f"broken aggregation must fail this gate, got {broken}"


def test_structural_gate_ns_sage():
    import re

    args = ("--dataset", "reddit", "--scale", "0.01", "--num-epochs", "8",
            "--batch-size", "256", "--fan-out", "10,10", "--eval-every", "7")
    out = _run_env(_STRUCT, "benchmarks/sampling/ns_sage.py", *args)
    accs = re.findall(r"Test Acc: ([0-9.]+)", out)
    assert accs and float(accs[-1]) > 0.35, out[-500:]
    out_b = _run_env(_BROKEN, "benchmarks/sampling/ns_sage.py", *args)
    accs_b = re.findall(r"Test Acc: ([0-9.]+)", out_b)
    assert accs_b and float(accs_b[-1]) < 0.25, out_b[-500:]


def test_structural_numerics_equivalence():
    """The blocked prefix-scan segment sum (DGL_JAX_SEGSUM=cumsum) must
    reach the same final accuracy as the exact scatter reduction over a
    full training run."""
    args = ("--dataset", "reddit", "--scale", "0.01", "--epochs", "25",
            "--runs", "1", "--eval")
    accs = {}
    for mode in ("scatter", "cumsum"):
        env = dict(_STRUCT, DGL_JAX_SEGSUM=mode)
        accs[mode] = _final_test(
            _run_env(env, "benchmarks/node_classification/main_sage.py", *args)
        )
    base = accs["scatter"]
    for mode, acc in accs.items():
        assert abs(acc - base) < 3.0, f"{mode} diverged: {accs}"
