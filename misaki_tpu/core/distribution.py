"""Discrete sampling distributions
(reference: include/misaki/core/distribution.h).

Build-time (NumPy): CDF tables. Render-time (jnp): vectorized searchsorted
with sample reuse — the wavefront replacement for the reference's per-call
binary search.
"""

import jax.numpy as jnp
import numpy as np


def build_cdf(weights):
    """Unnormalized weights -> (normalized cdf float32 (N,), total)."""
    w = np.asarray(weights, dtype=np.float64)
    c = np.cumsum(w)
    total = c[-1]
    if total <= 0:
        raise ValueError("Distribution with zero total mass")
    return (c / total).astype(np.float32), float(total)


def sample_reuse(cdf, u):
    """Sample an index from a normalized CDF and rescale u for reuse
    (distribution.h sample_reuse). cdf: (N,), u: (...,). Returns (idx, u')."""
    idx = jnp.searchsorted(cdf, u, side="right")
    idx = jnp.clip(idx, 0, cdf.shape[0] - 1)
    lo = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
    hi = cdf[idx]
    u_new = (u - lo) / jnp.maximum(hi - lo, 1e-20)
    return idx, jnp.clip(u_new, 0.0, 1.0 - 1e-7)


def pdf_discrete(cdf, idx):
    lo = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
    return cdf[idx] - lo
