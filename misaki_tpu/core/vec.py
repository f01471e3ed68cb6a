"""Component-tuple SoA vector math — the wavefront's data layout.

Arrays shaped (L, 3) interleave the 3-vector's components in the minor
dimension, so every elementwise op strides through memory and vector units
run a third full. We therefore carry every per-lane vector as a python tuple
of component arrays:

    v3 = (x, y, z)         # each (L,) float32
    v2 = (u, v)
    spectra stay (4, L) jnp arrays ("Spec": wavelength-major, lane-minor)

Each component is a full contiguous (L,) array; all vector arithmetic
decomposes into dense elementwise ops. Tuples are
pytrees, so they flow through lax control flow and jit unchanged.
"""

import jax.numpy as jnp


def v3(x, y, z):
    return (x, y, z)


def splat3(c, like):
    """Constant vector broadcast against a lane array."""
    o = jnp.ones_like(like)
    return (o * c[0], o * c[1], o * c[2])


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def neg(a):
    return (-a[0], -a[1], -a[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def norm2(a):
    return dot(a, a)


def norm(a):
    return jnp.sqrt(norm2(a))


def normalize(a):
    inv = 1.0 / jnp.sqrt(jnp.maximum(norm2(a), 1e-30))
    return scale(a, inv)


def where(mask, a, b):
    """Per-lane select between two vec3s; mask is (L,)."""
    return (
        jnp.where(mask, a[0], b[0]),
        jnp.where(mask, a[1], b[1]),
        jnp.where(mask, a[2], b[2]),
    )


def lerp(a, b, t):
    return (
        a[0] * (1.0 - t) + b[0] * t,
        a[1] * (1.0 - t) + b[1] * t,
        a[2] * (1.0 - t) + b[2] * t,
    )


def max_abs(a):
    return jnp.maximum(jnp.abs(a[0]), jnp.maximum(jnp.abs(a[1]), jnp.abs(a[2])))


def stack(a):
    """(3, L) array from a tuple — boundary/debug only, not the hot path."""
    return jnp.stack(a, axis=0)


def unstack(arr, axis=-1):
    """Tuple from an (..., 3) or (3, ...) array."""
    if axis == -1:
        return (arr[..., 0], arr[..., 1], arr[..., 2])
    return (arr[0], arr[1], arr[2])


def gather(cols, idx):
    """Gather a per-face vec3 stored as component arrays: cols = (X, Y, Z)
    each (F,), idx (L,) -> vec3 of (L,)."""
    return (cols[0][idx], cols[1][idx], cols[2][idx])


# ---- 2D helpers -----------------------------------------------------------

def v2(x, y):
    return (x, y)


def where2(mask, a, b):
    return (jnp.where(mask, a[0], b[0]), jnp.where(mask, a[1], b[1]))
