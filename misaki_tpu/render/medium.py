"""Wavefront medium kernels: homogeneous free-flight sampling, analytic
transmittance, and phase functions
(reference: src/librender/media/homogeneous.cpp:21-55,
src/librender/phase/isotropic.cpp:12-27,
src/librender/scene.cpp:114-184 eval_transmittance).

Redesign notes
--------------
* The reference keeps RGB extinction coefficients and channel-samples over
  3 RGB channels (volpath.cpp:39). Our pipeline is spectral: sigma_s/sigma_a
  are upsampled to the 4 hero wavelengths via the same sigmoid model as every
  other color (amplitude carried separately since extinction can exceed 1),
  and the distance-sampling channel is one of the 4 hero wavelengths. The
  pdf is the spectral mean, exactly mirroring homogeneous.cpp:26-44.
* Per-lane medium state is an int32 id (-1 = vacuum); medium parameters are
  gathered per lane (core/table.py fetch).
* Phase: Henyey-Greenstein with g stored per medium — g == 0 reduces
  *exactly* to the reference's isotropic (uniform sphere, pdf = 1/4pi,
  weight 1).
"""

import jax
import jax.numpy as jnp

from misaki_tpu.core import frame, math as m, table, vec

_TINY = 1e-20
INV_4PI = 1.0 / (4.0 * jnp.pi)


def fetch_medium(scene, med_ids, wavelengths):
    """Per-lane spectral medium parameters for int32 medium ids (-1 = vacuum).

    Returns dict {sigma_s (4, L), sigma_t (4, L), g (L,), vacuum (L,)}.
    Lanes in vacuum get sigma == 0 and g == 0.
    """
    med = scene.media
    M = med.kind.shape[0]
    L = med_ids.shape[0]
    if M == 0:
        z = jnp.zeros((4, L))
        return {
            "sigma_s": z,
            "sigma_t": z,
            "g": jnp.zeros(L),
            "vacuum": jnp.ones(L, bool),
        }
    # Pack the per-medium scalars into one (C, M) matrix -> single gather.
    # Columns: ss coeffs(3), sa coeffs(3), ss_amp, sa_amp, scale, g.
    cols = jnp.concatenate(
        [
            med.sigma_s_coeff.T,                       # 0-2
            med.sigma_a_coeff.T,                       # 3-5
            (med.sigma_s_amp * med.scale)[None, :],    # 6
            (med.sigma_a_amp * med.scale)[None, :],    # 7
            med.g[None, :],                            # 8
        ],
        axis=0,
    )
    vacuum = med_ids < 0
    f = table.fetch(cols, jnp.maximum(med_ids, 0))  # (9, L)

    def sig_eval(c0, c1, c2):
        v = (c0[None, :] * wavelengths + c1[None, :]) * wavelengths + c2[None, :]
        return jnp.maximum(0.5 * v / jnp.sqrt(v * v + 1.0) + 0.5, 0.0)

    sigma_s = sig_eval(f[0], f[1], f[2]) * f[6][None, :]
    sigma_a = sig_eval(f[3], f[4], f[5]) * f[7][None, :]
    sigma_s = jnp.where(vacuum[None, :], 0.0, sigma_s)
    sigma_a = jnp.where(vacuum[None, :], 0.0, sigma_a)
    return {
        "sigma_s": sigma_s,
        "sigma_t": sigma_s + sigma_a,
        "g": jnp.where(vacuum, 0.0, f[8]),
        "vacuum": vacuum,
    }


# ---------------------------------------------------------------------------
# spatially-varying density (reference volume.h Volume::eval + gridvolume)
# ---------------------------------------------------------------------------

HETERO_STEPS = 32  # fixed-step march resolution (static; no data-dep loops)


def fetch_density_vol(scene, med_ids):
    """Per-lane density-volume index (-1 = constant density 1)."""
    med = scene.media
    if med.kind.shape[0] == 0:
        return jnp.full(med_ids.shape, -1, jnp.int32)
    row = med.density_vol.astype(jnp.float32)[None, :]
    v = table.fetch(row, jnp.maximum(med_ids, 0))[0]
    return jnp.where(med_ids >= 0, v.astype(jnp.int32), -1)


def grid_density(scene, vol_ids, p):
    """Trilinear density of each lane's volume at world point p
    (volume.h Volume::eval generalized from constant3d to grids). Grids are
    gathered from the flat (1, Npad) atlas (core/table.fetch_lowp — the
    bitmap-atlas pattern); the static per-volume world->unit 3x4 lives in
    scene.volume_meta, so lanes in
    different volumes are handled by a masked unroll over the (few) grids.
    vol_ids: (L,) int32, -1 -> density 1. Outside a grid's bbox: 0."""
    meta = getattr(scene, "volume_meta", ())
    L = p[0].shape[0]
    out = jnp.ones(L)
    if not meta:
        return out
    for vi, (off, W, H, D, m12) in enumerate(meta):
        x = m12[0] * p[0] + m12[1] * p[1] + m12[2] * p[2] + m12[3]
        y = m12[4] * p[0] + m12[5] * p[1] + m12[6] * p[2] + m12[7]
        z = m12[8] * p[0] + m12[9] * p[1] + m12[10] * p[2] + m12[11]
        inside = (
            (x >= 0.0) & (x <= 1.0) & (y >= 0.0) & (y <= 1.0)
            & (z >= 0.0) & (z <= 1.0)
        )
        sel = vol_ids == vi
        # cell-centered trilinear (clamped, like the reference's
        # interpolation at the grid border)
        fx = jnp.clip(x * W - 0.5, 0.0, W - 1.0)
        fy = jnp.clip(y * H - 0.5, 0.0, H - 1.0)
        fz = jnp.clip(z * D - 0.5, 0.0, D - 1.0)
        x0 = jnp.floor(fx)
        y0 = jnp.floor(fy)
        z0 = jnp.floor(fz)
        tx, ty, tz = fx - x0, fy - y0, fz - z0
        x0i = x0.astype(jnp.int32)
        y0i = y0.astype(jnp.int32)
        z0i = z0.astype(jnp.int32)
        x1i = jnp.minimum(x0i + 1, W - 1)
        y1i = jnp.minimum(y0i + 1, H - 1)
        z1i = jnp.minimum(z0i + 1, D - 1)
        acc = jnp.zeros(L)
        for zi, wz in ((z0i, 1.0 - tz), (z1i, tz)):
            for yi, wy in ((y0i, 1.0 - ty), (y1i, ty)):
                for xi, wx in ((x0i, 1.0 - tx), (x1i, tx)):
                    idx = jnp.where(sel, off + (zi * H + yi) * W + xi, 0)
                    acc = acc + (table.fetch_lowp(scene.volumes, idx)[0]
                                 * (wx * wy * wz))
        out = jnp.where(sel, jnp.where(inside, acc, 0.0), out)
    return out


def _march_optical_depth(scene, mp, vol_ids, o, d, t_lo, t_hi, channel, u1):
    """Fixed-step (HETERO_STEPS) piecewise-constant march along o + t*d over
    [t_lo, t_hi]: accumulates spectral optical depth and inverts the
    channel's optical-depth CDF at target -log(1-u1). Returns
    (t_scatter, found, tau_spec_at_scatter (4, L), tau_spec_total (4, L),
    sigma_spec_at_scatter (4, L))."""
    L = u1.shape[0]
    span = jnp.maximum(t_hi - t_lo, 0.0)
    dt = span / HETERO_STEPS
    target = -jnp.log1p(-jnp.minimum(u1, 1.0 - 1e-7))
    onehot = (
        jnp.arange(4, dtype=jnp.int32)[:, None] == channel[None, :]
    ).astype(jnp.float32)

    def body(i, carry):
        tau_c, tau_s, found, t_sc, tau_at, sig_at = carry
        t_mid = t_lo + (i + 0.5) * dt
        x = vec.add(o, vec.scale(d, t_mid))
        rho = grid_density(scene, vol_ids, x)
        sig_spec = mp["sigma_t"] * rho[None, :]          # (4, L)
        sig_c = jnp.sum(sig_spec * onehot, axis=0)       # (L,)
        step_tau = sig_c * dt
        cross = ~found & (tau_c + step_tau >= target) & (sig_c > 0.0)
        frac = jnp.where(
            cross, (target - tau_c) / jnp.maximum(sig_c, _TINY), 0.0
        )
        t_new = t_lo + i * dt + jnp.clip(frac, 0.0, dt)
        t_sc = jnp.where(cross, t_new, t_sc)
        tau_at = jnp.where(
            cross[None, :], tau_s + sig_spec * frac[None, :], tau_at
        )
        sig_at = jnp.where(cross[None, :], sig_spec, sig_at)
        return (
            tau_c + step_tau,
            tau_s + sig_spec * dt,
            found | cross,
            t_sc,
            tau_at,
            sig_at,
        )

    z4 = jnp.zeros((4, L))
    init = (jnp.zeros(L), z4, jnp.zeros(L, bool), jnp.full(L, jnp.inf),
            z4, z4)
    _, tau_s, found, t_sc, tau_at, sig_at = jax.lax.fori_loop(
        0, HETERO_STEPS, body, init
    )
    return t_sc, found, tau_at, tau_s, sig_at


def _grid_span(scene, vol_ids, o, d, tmax):
    """[t_lo, t_hi] where the lane's grid volume can have density: the slab
    interval of the unit cube in volume space, clipped to [0, tmax]."""
    meta = getattr(scene, "volume_meta", ())
    L = tmax.shape[0]
    t_lo = jnp.zeros(L)
    t_hi = jnp.minimum(tmax, 3e38)
    for vi, (off, W, H, D, m12) in enumerate(meta):
        sel = vol_ids == vi
        ol = (
            m12[0] * o[0] + m12[1] * o[1] + m12[2] * o[2] + m12[3],
            m12[4] * o[0] + m12[5] * o[1] + m12[6] * o[2] + m12[7],
            m12[8] * o[0] + m12[9] * o[1] + m12[10] * o[2] + m12[11],
        )
        dl = (
            m12[0] * d[0] + m12[1] * d[1] + m12[2] * d[2],
            m12[4] * d[0] + m12[5] * d[1] + m12[6] * d[2],
            m12[8] * d[0] + m12[9] * d[1] + m12[10] * d[2],
        )
        tn = jnp.zeros(L)
        tf = jnp.minimum(tmax, 3e38)
        for k in range(3):
            inv = 1.0 / jnp.where(jnp.abs(dl[k]) < 1e-20,
                                  jnp.where(dl[k] < 0, -1e-20, 1e-20), dl[k])
            t0 = (0.0 - ol[k]) * inv
            t1 = (1.0 - ol[k]) * inv
            tn = jnp.maximum(tn, jnp.minimum(t0, t1))
            tf = jnp.minimum(tf, jnp.maximum(t0, t1))
        t_lo = jnp.where(sel, jnp.minimum(tn, tf), t_lo)
        t_hi = jnp.where(sel, tf, t_hi)
    return t_lo, jnp.maximum(t_hi, t_lo)


def transmittance_ray(scene, mp, med_ids, o, d, dist):
    """Spectral transmittance along a ray segment, heterogeneous-aware:
    grid lanes march (fixed-step quadrature), constant lanes use the closed
    form. Replaces eval_transmittance where a ray origin/direction is known
    (Scene::eval_transmittance, scene.cpp:160-166)."""
    homog = eval_transmittance(mp, dist)
    if not getattr(scene, "volume_meta", ()):
        return homog
    vol_ids = fetch_density_vol(scene, med_ids)
    t_lo, t_hi = _grid_span(scene, vol_ids, o, d, dist)
    _, _, _, tau_total, _ = _march_optical_depth(
        scene, mp, vol_ids, o, d, t_lo, t_hi,
        jnp.zeros(dist.shape, jnp.int32), jnp.zeros_like(dist),
    )
    het = jnp.exp(-tau_total)
    return jnp.where((vol_ids >= 0)[None, :], het, homog)


def sample_distance(mp, channel, u1, tmax, scene=None, o=None, d=None,
                    med_ids=None):
    """HomogeneousMedium::sample_distance (homogeneous.cpp:21-50), SoA.

    mp: fetch_medium dict; channel: (L,) int32 hero-wavelength index in
    [0, 4); u1: (L,) uniform; tmax: (L,) distance to the surface hit.
    With `scene`/`o`/`d`/`med_ids` given and the scene carrying grid
    volumes, lanes whose medium has a density grid instead invert the
    marched piecewise-constant optical depth (fixed-step quadrature; the
    reference has no heterogeneous sampling at all — volume.h only declares
    the eval interface).

    Returns {scatter (L,) bool, t (L,), pdf (L,), tr (4, L)} where
    * scatter: the free-flight ended before the surface;
    * t: sampled distance (only meaningful when scatter);
    * pdf: spectral-mean pdf of what happened (density if scatter, survival
      probability otherwise);
    * tr: transmittance over the traveled segment;
    * rho: (L,) relative density at the scatter point (1 for homogeneous
      lanes). Heterogeneous in-scattering weights sigma_s(x) = sigma_s*rho,
      matching the rho folded into the pdf — omitting it biases scatter
      contributions by 1/rho (advisor r4 #1).
    """
    onehot = (
        jnp.arange(4, dtype=jnp.int32)[:, None] == channel[None, :]
    ).astype(jnp.float32)
    sigma_c = jnp.sum(mp["sigma_t"] * onehot, axis=0)  # (L,)
    # -log(1-u)/sigma; vacuum (sigma==0) -> inf
    dist = -jnp.log1p(-jnp.minimum(u1, 1.0 - 1e-7)) / jnp.maximum(sigma_c, _TINY)
    dist = jnp.where(sigma_c > 0.0, dist, jnp.inf)
    scatter = dist < tmax
    traveled = jnp.where(scatter, dist, jnp.minimum(tmax, 3e38))
    tr = jnp.exp(-mp["sigma_t"] * traveled[None, :])
    # spectral-mean pdfs (homogeneous.cpp:36-42)
    pdf_scatter = jnp.mean(tr * mp["sigma_t"], axis=0)
    pdf_escape = jnp.mean(tr, axis=0)
    pdf = jnp.where(scatter, pdf_scatter, pdf_escape)
    # tr.maxCoeff() < 1e-20 -> zero (homogeneous.cpp:45-46)
    tr = jnp.where(jnp.max(tr, axis=0) < 1e-20, 0.0, tr)
    out = {"scatter": scatter, "t": dist, "pdf": pdf, "tr": tr,
           "rho": jnp.ones_like(pdf)}

    if (scene is None or o is None
            or not getattr(scene, "volume_meta", ())):
        return out
    vol_ids = fetch_density_vol(scene, med_ids)
    grid_lane = vol_ids >= 0
    t_lo, t_hi = _grid_span(scene, vol_ids, o, d, tmax)
    t_sc, found, tau_at, tau_total, sig_at = _march_optical_depth(
        scene, mp, vol_ids, o, d, t_lo, t_hi, channel, u1
    )
    h_scatter = found & (t_sc < tmax)
    tr_h = jnp.where(h_scatter[None, :], jnp.exp(-tau_at),
                     jnp.exp(-tau_total))
    pdf_h = jnp.where(
        h_scatter,
        jnp.mean(sig_at * jnp.exp(-tau_at), axis=0),
        jnp.mean(jnp.exp(-tau_total), axis=0),
    )
    # relative density at the scatter point: sig_at == sigma_t * rho(x), so
    # any non-degenerate channel recovers rho (use the hero channel)
    sig_at_c = jnp.sum(sig_at * onehot, axis=0)
    rho_h = sig_at_c / jnp.maximum(sigma_c, _TINY)
    return {
        "scatter": jnp.where(grid_lane, h_scatter, scatter),
        "t": jnp.where(grid_lane, t_sc, dist),
        "pdf": jnp.where(grid_lane, pdf_h, pdf),
        "tr": jnp.where(grid_lane[None, :], tr_h, tr),
        "rho": jnp.where(grid_lane & h_scatter, rho_h, out["rho"]),
    }


def eval_transmittance(mp, dist):
    """exp(-sigma_t * dist) (homogeneous.cpp:52-55). dist: (L,) -> (4, L)."""
    return jnp.exp(-mp["sigma_t"] * jnp.maximum(dist, 0.0)[None, :])


# ---------------------------------------------------------------------------
# phase functions (Henyey-Greenstein; g = 0 == reference isotropic)
# ---------------------------------------------------------------------------

def hg_pdf(cos_theta, g):
    """HG phase density over solid angle, cos_theta measured between the
    direction of travel and the scattered direction (mean cosine == g,
    forward-peaked for g > 0); g==0 -> 1/4pi (isotropic.cpp)."""
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / jnp.maximum(denom * jnp.sqrt(denom), _TINY)


def phase_eval(wi_world, wo_world, g):
    """PhaseFunction::eval — density of scattering from direction of travel
    `wi_world` (the ray direction) into `wo_world`. isotropic.cpp:24-27
    returns the uniform-sphere pdf; HG generalizes by cos(theta)."""
    return hg_pdf(vec.dot(wi_world, wo_world), g)


def phase_sample(wi_world, g, u2):
    """PhaseFunction::sample -> (wo (vec3), pdf (L,), weight (L,)).

    weight == 1 always (perfect importance sampling), matching
    isotropic.cpp:15-22 at g == 0.
    """
    # HG inverse-CDF for cos(theta) around the direction of travel; the
    # g -> 0 limit is cos = 1 - 2u (uniform sphere).
    safe_g = jnp.where(jnp.abs(g) < 1e-4, 1e-4, g)
    sqr_term = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u2[0])
    cos_hg = (1.0 + safe_g * safe_g - sqr_term * sqr_term) / (2.0 * safe_g)
    cos_theta = jnp.where(jnp.abs(g) < 1e-4, 1.0 - 2.0 * u2[0], cos_hg)
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * jnp.pi * u2[1]
    fr = frame.make_frame(wi_world)
    local = (sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)
    wo = frame.to_world(fr, local)
    pdf = hg_pdf(cos_theta, g)
    return wo, pdf, jnp.ones_like(pdf)
