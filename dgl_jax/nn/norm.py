"""Normalization layers for padded graph batches.

The reference uses plain ``nn.BatchNorm1d`` over node features
(``main_dgl_arxiv_sage.py:81-99``, ``main_dgl_enzymes_gcn.py``). Here,
batched graphs carry padding nodes (static-shape discipline), so batch
statistics must be computed over *valid* nodes only — a plain BatchNorm
would average zeros into the stats. :class:`MaskedBatchNorm` is the
padding-aware equivalent; with ``mask=None`` it reduces to standard BN.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from . import linen as nn

__all__ = ["MaskedBatchNorm"]


class MaskedBatchNorm(nn.Module):
    momentum: float = 0.9  # torch BatchNorm1d default momentum=0.1 ⇒ ema 0.9
    epsilon: float = 1e-5
    use_scale: bool = True
    use_bias: bool = True

    @nn.compact
    def __call__(
        self,
        x: jnp.ndarray,  # (N, D)
        mask: Optional[jnp.ndarray] = None,  # (N,) 1=valid
        *,
        use_running_average: bool = False,
    ):
        d = x.shape[-1]
        ra_mean = self.variable("batch_stats", "mean", lambda: jnp.zeros(d, x.dtype))
        ra_var = self.variable("batch_stats", "var", lambda: jnp.ones(d, x.dtype))

        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            if mask is None:
                mean = jnp.mean(x, axis=0)
                var = jnp.mean((x - mean) ** 2, axis=0)
            else:
                m = mask.astype(x.dtype)[:, None]
                count = jnp.maximum(jnp.sum(m), 1.0)
                mean = jnp.sum(x * m, axis=0) / count
                var = jnp.sum(((x - mean) ** 2) * m, axis=0) / count
            if not self.is_initializing():
                ra_mean.value = self.momentum * ra_mean.value + (1 - self.momentum) * mean
                ra_var.value = self.momentum * ra_var.value + (1 - self.momentum) * var

        y = (x - mean) / jnp.sqrt(var + self.epsilon)
        if self.use_scale:
            y = y * self.param("scale", nn.initializers.ones, (d,))
        if self.use_bias:
            y = y + self.param("bias", nn.initializers.zeros, (d,))
        return y
