"""What the GPU bring-up relies on, checked on the CPU: the compile-cache
path rule, the native library key, memory budgets from the device, the
kernel benchmark's peak table, and chip_smoke's device check, error
measure and op comparisons. The ``gpu`` test runs those comparisons on a
card where JAX sees one."""

import importlib.util
import os
import sys

import numpy as np
import pytest

import jax

import dgl_jax
from dgl_jax import memory
from dgl_jax.csrc import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chip_smoke():
    return _load("chip_smoke", "chip_smoke.py")


@pytest.fixture(scope="module")
def bench_kernels():
    return _load("bench_kernels", "kernel/bench_kernels.py")


# -- compile cache ----------------------------------------------------------


def test_compile_cache_defers_to_env():
    assert dgl_jax.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None


def test_compile_cache_default_is_fixed_checkout_path():
    d = dgl_jax.compile_cache_dir({})
    assert d == os.path.join(REPO, ".jax_cache")
    assert d == dgl_jax.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""})


# -- native library key -------------------------------------------------------


@pytest.mark.parametrize("change", ["source", "flags", "cpu"])
def test_native_library_key_changes_with_inputs(change):
    base = dict(source=b"int f();", flags=("-O3",), cpu="model name: A")
    other = dict(base, **{change: {"source": b"int g();", "flags": ("-O2",),
                                   "cpu": "model name: B"}[change]})
    assert native.library_key(**base) == native.library_key(**dict(base))
    assert native.library_key(**base) != native.library_key(**other)


def test_native_library_path_names_this_host():
    path = native.library_path()
    with open(os.path.join(os.path.dirname(native.__file__), "graph_ops.cpp"), "rb") as f:
        key = native.library_key(f.read(), native._FLAGS, native.host_cpu())
    assert os.path.basename(path) == f"libgraph_ops-{key}.so"


# -- memory budgets -----------------------------------------------------------


def test_memory_budget_shares_of_device(monkeypatch):
    # the CPU reports no limit: budgets are shares of the fixed fallback
    assert memory.device_memory_bytes() == memory.FALLBACK_BYTES
    assert memory.memory_share(3 / 16) == 3 * (1 << 30)
    monkeypatch.delenv("DGL_JAX_MSG_BUDGET_GB", raising=False)
    assert memory.msg_budget_bytes() == 4 * (1 << 30)


def test_memory_budget_env_override(monkeypatch):
    monkeypatch.setenv("DGL_JAX_MSG_BUDGET_GB", "0.5")
    assert memory.msg_budget_bytes() == 0.5 * (1 << 30)


# -- kernel benchmark peaks -----------------------------------------------------


def test_peak_table_knows_h100(bench_kernels):
    assert bench_kernels.peak_hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA GeForce RTX 4090", "NVIDIA H100 PCIe"])
def test_peak_table_rejects_unknown_device(bench_kernels, kind):
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        bench_kernels.peak_hbm_bytes_per_s(kind)


def test_min_bytes_spmm(bench_kernels):
    # features read once + 8 index bytes per edge + output written once
    assert bench_kernels.min_bytes("spmm", 10, 20, 100, 16) == 10 * 64 + 800 + 20 * 64
    assert bench_kernels.min_bytes("spmm_bwd", 10, 20, 100, 16) == 20 * 64 + 800 + 10 * 64
    with pytest.raises(ValueError):
        bench_kernels.min_bytes("lane", 1, 1, 1, 1)


# -- chip_smoke -----------------------------------------------------------------


def test_chip_smoke_refuses_cpu(chip_smoke):
    assert jax.default_backend() == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


def test_chip_smoke_rel_err_floor(chip_smoke):
    ref = np.array([[3.0, 4.0], [0.0, 0.0], [6.0, 8.0]])
    out = ref + np.array([[0.0, 5e-4], [3e-7, 0.0], [0.0, 0.0]])
    # row 0: 5e-4 / 5 = 1e-4; row 1 (a zero row) against the floor
    # 1e-3 * median(5, 10): 4e-5
    assert chip_smoke.rel_err(out, ref) == pytest.approx(1e-4)
    assert chip_smoke.rel_err(out, ref, scale=np.array([50.0, 1.0, 1.0])) == \
        pytest.approx(1e-5)


def test_chip_smoke_checks_fail_loudly(chip_smoke, capsys):
    checks = chip_smoke.Checks("t")
    checks.add("good", 1e-6, 1e-4, "r")
    checks.raise_if_failed()
    checks.add("nan", float("nan"), 1e-4, "r")
    with pytest.raises(SystemExit, match=r"t: failed \['nan'\]"):
        checks.raise_if_failed()
    assert "FAIL nan" in capsys.readouterr().out


def _small_graph(seed=0, n=200, e=1500):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - 20, e)  # last 20 nodes: zero in-degree
    x = rng.standard_normal((n, 64)).astype(np.float32)
    return src, dst, n, x


def test_chip_smoke_op_checks_pass_on_cpu(chip_smoke):
    cpu = jax.devices("cpu")[0]
    src, dst, n, x = _small_graph()
    checks = chip_smoke.check_ops(src, dst, n, x, cpu, cpu, widths=(16,), heads=2)
    assert checks.failed == []


@pytest.mark.gpu
def test_chip_smoke_op_checks_on_gpu(chip_smoke, gpu):
    cpu = jax.devices("cpu")[0]
    src, dst, n, x = _small_graph()
    with jax.default_matmul_precision("highest"):
        checks = chip_smoke.check_ops(src, dst, n, x, gpu, cpu)
    assert checks.failed == []
