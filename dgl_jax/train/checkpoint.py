"""Checkpoint / resume as npz files.

The reference has **no** model/optimizer checkpointing (SURVEY §5 — its only
persistent artifacts are partition caches and CSV logs). This adds the
missing capability: the full train state pytree (params / optimizer state /
batch stats / step / RNG key) saved as one ``step_<n>.npz`` per save,
written atomically (temp file + rename), with retention and resume. Leaves
are stored as raw unsigned-integer views beside their dtype names, so
dtypes numpy cannot name (bfloat16) survive the round trip.

Restoring needs a template of the same structure (the freshly initialized
state): leaves are matched by their order in the flattened pytree and
checked for shape and dtype.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")


class CheckpointManager:
    """Save, list and restore train-state checkpoints in one directory.

    Usage::

        ckpt = CheckpointManager(dir, max_to_keep=3)
        state, start = ckpt.restore_or(state)   # resume if anything saved
        ...
        ckpt.save(step, state)                  # every save_interval steps
    """

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval: int = 1):
        if max_to_keep < 1 or save_interval < 1:
            raise ValueError("max_to_keep and save_interval must be >= 1")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.npz")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Write ``state`` as step ``step`` when ``step`` is a multiple of
        ``save_interval`` (or ``force``); returns whether it wrote."""
        if not force and step % self.save_interval:
            return False
        leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(state)]
        arrays = {f"leaf_{i}": a.view(f"u{a.dtype.itemsize}")
                  for i, a in enumerate(leaves)}
        arrays["dtypes"] = np.array([str(a.dtype) for a in leaves])
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        for old in self.all_steps()[: -self.max_to_keep]:
            os.unlink(self._path(old))
        return True

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``state_template``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        leaves, treedef = jax.tree_util.tree_flatten(state_template)
        with np.load(self._path(step)) as z:
            dtypes = z["dtypes"]
            if len(dtypes) != len(leaves):
                raise ValueError(
                    f"checkpoint step {step} has {len(dtypes)} leaves, the "
                    f"template {len(leaves)}")
            restored = []
            for i, ref in enumerate(leaves):
                a = z[f"leaf_{i}"].view(jnp.dtype(str(dtypes[i])))
                ref = np.asarray(ref)
                if a.shape != ref.shape or a.dtype != ref.dtype:
                    raise ValueError(
                        f"checkpoint leaf {i}: {a.dtype}{list(a.shape)} does "
                        f"not match the template's {ref.dtype}{list(ref.shape)}")
                restored.append(a)
        return jax.tree_util.tree_unflatten(treedef, restored)

    def restore_or(self, state: Any) -> tuple[Any, int]:
        """(state, start_step): restored if a checkpoint exists, else as given."""
        step = self.latest_step()
        if step is None:
            return state, 0
        return self.restore(state, step), step + 1
