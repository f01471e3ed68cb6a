"""Jakob-Hanika sRGB -> smooth-spectrum upsampling.

The reference loads a precomputed 3D coefficient table (`data/srgb.coeff`)
built offline by ext/rgb2spec's optimizer, then evaluates a 3-coefficient
sigmoid model per wavelength (include/misaki/render/srgb.h:8-19).

Redesign: instead of shipping a 64^3 table, we fit the three
coefficients **per distinct scene color at scene-compile time** with a damped
Gauss-Newton solve (NumPy, float64) against the same objective the rgb2spec
optimizer uses: the sigmoid spectrum, illuminated by D65 and integrated
against the CIE 1931 observer, must reproduce the requested sRGB color.
Scenes have a handful of distinct colors, so this costs microseconds and
removes a binary data dependency. The in-render `srgb_model_eval` is the same
5-op closed form as the reference and is differentiable w.r.t. coefficients.
"""

import jax.numpy as jnp
import numpy as np

from misaki_tpu.core.cie_data import (
    CIE1931_X,
    CIE1931_Y,
    CIE1931_Z,
    CIE_MAX,
    CIE_MIN,
    CIE_SAMPLES,
    D65_DATA,
)

# Fitting operates on normalized wavelength x = (lambda - CIE_MIN) / SPAN.
_SPAN = CIE_MAX - CIE_MIN

_SRGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
_XYZ_TO_SRGB = np.linalg.inv(_SRGB_TO_XYZ)

_LAMBDA = np.linspace(CIE_MIN, CIE_MAX, CIE_SAMPLES)
_X_NORM = (_LAMBDA - CIE_MIN) / _SPAN
# Integration weights: D65-weighted CIE matching functions, normalized so a
# unit (flat 1.0) reflectance maps to the D65 white point with Y = 1.
_CMF = np.stack([CIE1931_X, CIE1931_Y, CIE1931_Z], axis=0).astype(np.float64)
_D65W = D65_DATA.astype(np.float64)
_K = 1.0 / np.sum(_D65W * _CMF[1])
_W = _K * _D65W[None, :] * _CMF  # (3, 95): spectrum -> XYZ quadrature


def _sigmoid(v):
    return 0.5 * v / np.sqrt(v * v + 1.0) + 0.5


def _model_rgb(p):
    """sRGB color produced by sigmoid poly p (in normalized-x domain)."""
    v = (p[0] * _X_NORM + p[1]) * _X_NORM + p[2]
    s = _sigmoid(v)
    xyz = _W @ s
    return _XYZ_TO_SRGB @ xyz


def fit_srgb_coeffs(rgb):
    """Fit (c0, c2, c2) of the nm-domain sigmoid polynomial for linear sRGB.

    Returns np.float64 (3,) coefficients in the *nanometer* domain, directly
    usable by `srgb_model_eval` (matching srgb.h:8-19 conventions).
    """
    rgb = np.asarray(rgb, dtype=np.float64)
    rgb = np.clip(rgb, 0.0, None)
    # Degenerate black/white: saturate the sigmoid hard.
    if np.max(rgb) < 1e-6:
        return np.array([0.0, 0.0, -1e4])

    # Start from a flat spectrum matching the luminance.
    y = float(np.clip(_SRGB_TO_XYZ[1] @ rgb, 1e-4, 1.0 - 1e-4))
    v0 = (y - 0.5) / np.sqrt(y * (1.0 - y))
    p = np.array([0.0, 0.0, v0])

    lam = 1e-4
    err = np.inf
    for _ in range(100):
        r = _model_rgb(p) - rgb
        new_err = float(r @ r)
        # Jacobian by forward differences (3x3, cheap and robust).
        J = np.empty((3, 3))
        for j in range(3):
            dp = np.zeros(3)
            dp[j] = 1e-5
            J[:, j] = (_model_rgb(p + dp) - _model_rgb(p - dp)) / 2e-5
        if new_err < err:
            err = new_err
            lam = max(lam * 0.5, 1e-8)
        else:
            lam = min(lam * 4.0, 1e4)
        if err < 1e-14:
            break
        A = J.T @ J + lam * np.eye(3)
        g = J.T @ r
        try:
            step = np.linalg.solve(A, g)
        except np.linalg.LinAlgError:
            break
        p = p - step
        if float(step @ step) < 1e-16:
            break

    # Convert from normalized-x domain to the nm domain:
    # v = p0*x^2 + p1*x + p2 with x = (lambda - L0)/S
    L0, S = CIE_MIN, _SPAN
    c0 = p[0] / (S * S)
    c1 = p[1] / S - 2.0 * L0 * p[0] / (S * S)
    c2 = p[0] * (L0 / S) ** 2 - p[1] * (L0 / S) + p[2]
    return np.array([c0, c1, c2])


def srgb_model_eval(coeff, wavelengths):
    """The reference's sigmoid eval (srgb.h:8-19), jnp + differentiable.

    coeff: (c0, c1, c2) tuple of (L,) per-lane nm-domain coefficients (or
    scalars); wavelengths: (4, L) wavelength-major. Returns (4, L)
    reflectance in [0, 1].
    """
    c0, c1, c2 = coeff
    v = (c0[None, :] * wavelengths + c1[None, :]) * wavelengths + c2[None, :]
    rsqrt = 1.0 / jnp.sqrt(v * v + 1.0)
    return jnp.maximum(0.5 * v * rsqrt + 0.5, 0.0)


def srgb_model_eval_flat(coeff, wavelengths):
    """Scalar-coefficient variant: coeff (3,) array, wavelengths any shape."""
    v = (coeff[0] * wavelengths + coeff[1]) * wavelengths + coeff[2]
    rsqrt = 1.0 / jnp.sqrt(v * v + 1.0)
    return jnp.maximum(0.5 * v * rsqrt + 0.5, 0.0)


def srgb_model_mean(coeff):
    """Mean reflectance over 16 equally spaced wavelengths.

    NOTE the reference's srgb_model_mean (srgb.h:21-36) has a bug — it
    linspaces from WAVELENGTH_MIN to WAVELENGTH_MIN, evaluating only at
    360nm. We implement the obvious intent (360..830); `mean()` is only used
    for emitter-importance heuristics, not radiance, so images are unaffected.
    """
    lam = jnp.linspace(360.0, 830.0, 16)
    c = jnp.asarray(coeff)
    v = (c[..., 0:1] * lam + c[..., 1:2]) * lam + c[..., 2:3]
    s = jnp.maximum(0.5 * v / jnp.sqrt(v * v + 1.0) + 0.5, 0.0)
    return jnp.mean(s, axis=-1)
