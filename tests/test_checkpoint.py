"""npz checkpoint manager (dgl_jax/train/checkpoint.py): round trip of a
full train state, retention, save interval, and template checks."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from dgl_jax.train import CheckpointManager


def _state(seed=0):
    params = {"conv_0": {"kernel": jax.random.normal(jax.random.PRNGKey(seed), (4, 3)),
                         "bias": jnp.zeros((3,))},
              "scale": jnp.ones((2,), jnp.bfloat16)}
    opt = optax.adam(1e-2).init(params)
    return (params, {"bn": {"mean": jnp.arange(3.0)}}, opt, jax.random.PRNGKey(seed))


def _assert_tree_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_round_trip_restores_structure_and_values(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    state = _state(1)
    assert ckpt.save(7, state)
    restored = ckpt.restore(_state(2))
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(state)
    _assert_tree_equal(restored, state)
    assert ckpt.latest_step() == 7


def test_restore_or_resumes_after_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    fresh = _state(0)
    state, start = ckpt.restore_or(fresh)
    assert start == 0 and state is fresh
    ckpt.save(3, _state(3))
    ckpt.save(5, _state(5))
    state, start = CheckpointManager(str(tmp_path)).restore_or(fresh)
    assert start == 6
    _assert_tree_equal(state, _state(5))


def test_retention_and_interval(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2, save_interval=2)
    written = [ckpt.save(s, _state(s)) for s in range(7)]
    assert written == [True, False, True, False, True, False, True]
    assert ckpt.all_steps() == [4, 6]
    assert ckpt.save(7, _state(7), force=True)
    assert ckpt.all_steps() == [6, 7]
    # atomic writes leave no temporary files behind
    assert sorted(os.listdir(tmp_path)) == ["step_6.npz", "step_7.npz"]


def test_template_mismatch_raises(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(0, _state(0))
    params, bn, opt, key = _state(0)
    params = dict(params, scale=jnp.ones((3,), jnp.bfloat16))
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore((params, bn, opt, key))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore((params, bn))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_state(0))
