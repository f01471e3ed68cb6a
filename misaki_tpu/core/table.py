"""Table access primitives.

  * `fetch(table (C, N), idx (L,))` — per-lane column gather: exact in
    float32, O(C * L) work whatever N is, and differentiable in `table`
    (the VJP is a scatter-add of the cotangent columns).

  * `hat_eval(values (N,), x (..., ))` — piecewise-linear table evaluation
    as an unrolled sum of hat (tent) basis functions: exactly equivalent to
    lerp-with-gather (regular.cpp eval_pdf semantics) but expressed as N
    fused FMA+relu vector ops. Used for the CIE 1931 and D65/regular
    spectrum lookups (95 bins).
"""

import jax.numpy as jnp
import numpy as np


def fetch(table, idx, n_valid=None):
    """table: (C, N); idx: (L,) int32. Returns (C, L) in table's dtype.

    Indices outside [0, N) return an all-zero column (callers mask invalid
    lanes anyway). The mask is explicit: `jnp.take(..., mode="fill")` wraps
    negative indices instead of filling them.
    """
    N = table.shape[1]
    ok = (idx >= 0) & (idx < N)
    cols = jnp.take(table, jnp.where(ok, idx, 0), axis=1, mode="clip")
    return jnp.where(ok[None, :], cols, jnp.zeros((), table.dtype))


def fetch_lowp(table, idx):
    """Texel-table fetch (bitmap atlas, volume grids): the same exact gather
    as `fetch`, returning the stored float32 texels."""
    return fetch(table, idx)


def hat_eval(values, t):
    """Sum_k values[k] * max(0, 1 - |t - k|) — the exact piecewise-linear
    interpolation of `values` at fractional index `t` (clamped to the ends),
    with no per-lane gathers. values: (N,); t: any shape. Differentiable in
    both `values` and `t`.
    """
    return hat_eval_multi([values], t)[0]


def hat_eval_multi(tables, t):
    """hat_eval for several tables sharing the same index — one basis
    evaluation, M accumulations. tables: list of (N,), t: any shape.

    Unrolled statically over the N bins: XLA fuses the whole sum into ONE
    elementwise kernel (t is read once, each accumulator written once — no
    per-iteration round trips through device memory); static numpy tables
    additionally fold to HLO constants."""
    n = tables[0].shape[0]
    t = jnp.clip(t, 0.0, n - 1.0)
    accs = [jnp.zeros_like(t) for _ in tables]
    static = [np.asarray(tab) if isinstance(tab, np.ndarray) else None
              for tab in tables]
    for k in range(n):
        w = jnp.maximum(0.0, 1.0 - jnp.abs(t - k))
        for i, tab in enumerate(tables):
            c = float(static[i][k]) if static[i] is not None else tab[k]
            accs[i] = accs[i] + c * w
    return accs


def sigmoid_inverse(v, eps=1e-4):
    """Map a reflectance value in [0,1] to the sigmoid-model constant c such
    that 0.5 c/sqrt(c^2+1) + 0.5 == v — used to encode `uniform` spectra as
    degenerate sigmoid coefficients (0, 0, c)."""
    v = np.clip(np.asarray(v, np.float64), eps, 1.0 - eps)
    return (v - 0.5) / np.sqrt(v * (1.0 - v))
