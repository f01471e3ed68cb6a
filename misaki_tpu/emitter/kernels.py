"""Wavefront emitter kernels: NEE direct sampling, pdf, and radiance eval
(reference: src/librender/emitters/{area,constant,point}.cpp and the uniform
emitter selection in scene.cpp:68-112).

Lane-last layout: radiance spectra are (sigmoid coeff x 95-bin curve) models
evaluated with hat-basis sums; per-emitter work is unrolled statically over
`scene.emitter_kinds` with lane masks; area sampling gathers face data from
the emitter's compact face pack (core/table.py fetch).
"""

import jax.numpy as jnp

from misaki_tpu.core import frame, math as m, table, vec, warp
from misaki_tpu.core.cie_data import CIE_MAX, CIE_MIN
from misaki_tpu.scene.types import (
    EF_CDF_HI,
    EF_CDF_LO,
    EF_E1,
    EF_E2,
    EF_HAS_N,
    EF_N0,
    EF_NG,
    EF_P0,
    EM_AREA,
    EM_CONSTANT,
    EM_ENVMAP,
    EM_POINT,
)


def radiance(scene, ei, wavelengths, rad=None):
    """Emitter radiance spectrum for a STATIC emitter index: L(lambda) =
    hat(curve)(lambda) * sigmoid(coeff)(lambda). Covers srgb_d65 / d65 /
    uniform / regular (see EmitterTable docstring). Returns (4, L).

    `rad` is an optional precomputed `radiance_all` cache: the spectrum
    depends only on the chunk's wavelengths, so integrators hoist it out of
    the bounce loop (it was re-evaluated ~9x per cbox sample before)."""
    if rad is not None:
        return rad[ei]
    coeff = scene.emitters.rad_coeff[ei]
    curve = scene.emitters.rad_curve[ei]
    t = (wavelengths - CIE_MIN) * (94.0 / (CIE_MAX - CIE_MIN))
    base = table.hat_eval(curve, t)
    v = (coeff[0] * wavelengths + coeff[1]) * wavelengths + coeff[2]
    sig = jnp.maximum(0.5 * v / jnp.sqrt(v * v + 1.0) + 0.5, 0.0)
    return base * sig


def radiance_all(scene, wavelengths):
    """Per-chunk radiance cache: list of (4, L) spectra, one per emitter.
    All emitter curves are evaluated with ONE shared hat-basis pass
    (hat_eval_multi) — wavelength-only dependence makes this loop-invariant
    for the whole chunk."""
    n = scene.n_emitters
    if n == 0:
        return None
    if n > 16:
        # this cache (and eval_emitter/sample_emitter_direct) unrolls
        # statically over emitters x 95 hat bins; dozens of emitters would
        # bloat the trace the same way `direct`'s unroll does (which warns
        # too). Skip the cache — radiance() falls back to per-call eval.
        from misaki_tpu.utils.logging import get_logger

        get_logger().warning(
            "radiance_all: %d emitters — skipping the per-chunk radiance "
            "cache (static unroll would bloat the trace); expect slower "
            "per-bounce emitter eval", n,
        )
        return None
    t = (wavelengths - CIE_MIN) * (94.0 / (CIE_MAX - CIE_MIN))
    bases = table.hat_eval_multi(
        [scene.emitters.rad_curve[ei] for ei in range(n)], t
    )
    out = []
    for ei in range(n):
        coeff = scene.emitters.rad_coeff[ei]
        v = (coeff[0] * wavelengths + coeff[1]) * wavelengths + coeff[2]
        sig = jnp.maximum(0.5 * v / jnp.sqrt(v * v + 1.0) + 0.5, 0.0)
        out.append(bases[ei] * sig)
    return out


def eval_emitter(scene, emitter_ids, wi_local, uv, wavelengths, rad=None):
    """Emitter::eval at a surface hit — area lights emit on the front side
    only (area.cpp:51-54). Lanes with emitter_ids < 0 return 0. -> (4, L).
    Unrolled statically over the scene's emitters."""
    L = wavelengths.shape[-1]
    out = jnp.zeros((4, L))
    front = frame.cos_theta(wi_local) > 0.0
    for ei in range(scene.n_emitters):
        if scene.emitter_kinds[ei] != EM_AREA:
            continue
        mask = (emitter_ids == ei) & front
        out = jnp.where(mask[None, :], radiance(scene, ei, wavelengths, rad), out)
    return out


# ---------------------------------------------------------------------------
# environment map (stale-set parity: emitters/envmap.cpp — lat-long HDR with
# 2D luminance-CDF importance sampling + sin-theta correction: texel and pmf
# fetches are gathers (core/table.py fetch), CDF inversion is compare-count
# reductions).
# ---------------------------------------------------------------------------


def _env_dir_to_uv(scene, d):
    """World direction -> lat-long (u, v) in the emitter's local frame.

    Convention (y-up), matching the reference exactly (envmap.cpp:65-67,76-78):
    u = atan2(x, -z) / 2pi (wrapped to [0,1)), v = acos(y) / pi.
    Returns (u, v, sin_t)."""
    R = scene.emitters.env_to_local
    x = R[0, 0] * d[0] + R[0, 1] * d[1] + R[0, 2] * d[2]
    y = R[1, 0] * d[0] + R[1, 1] * d[1] + R[1, 2] * d[2]
    z = R[2, 0] * d[0] + R[2, 1] * d[1] + R[2, 2] * d[2]
    u = jnp.arctan2(x, -z) * m.InvTwoPi
    u = u - jnp.floor(u)
    y = jnp.clip(y, -1.0, 1.0)
    v = jnp.arccos(y) * m.InvPi
    sin_t = jnp.sqrt(jnp.maximum(1.0 - y * y, 0.0))
    return u, v, sin_t


def _env_uv_to_dir(scene, u, v):
    """Inverse of _env_dir_to_uv: (u, v) -> world direction + sin(theta)
    (envmap.cpp:43-47: phi = u * 2pi, d = (sin(phi) sin(theta), cos(theta),
    -cos(phi) sin(theta)))."""
    theta = v * m.Pi
    phi = u * m.TwoPi
    st = jnp.sin(theta)
    local = (st * jnp.sin(phi), jnp.cos(theta), -st * jnp.cos(phi))
    R = scene.emitters.env_to_world
    d = (
        R[0, 0] * local[0] + R[0, 1] * local[1] + R[0, 2] * local[2],
        R[1, 0] * local[0] + R[1, 1] * local[1] + R[1, 2] * local[2],
        R[2, 0] * local[0] + R[2, 1] * local[1] + R[2, 2] * local[2],
    )
    return d, st


def _env_bilinear_rgb(scene, u, v):
    """Bilinear texel fetch from the (He, We, 3) map at texel centers.

    Four gathers from the flat (3, He*We) table; u wraps, v clamps. Returns
    (r, g, b) tuples of (L,). Differentiable in env_rgb (the gather's VJP
    is a scatter-add)."""
    env = scene.emitters.env_rgb
    He, We = env.shape[0], env.shape[1]
    fu = u * We - 0.5
    fv = v * He - 0.5
    j0 = jnp.floor(fu)
    i0 = jnp.floor(fv)
    tu = fu - j0
    tv = fv - i0
    j0i = jnp.mod(j0.astype(jnp.int32), We)
    j1i = jnp.mod(j0.astype(jnp.int32) + 1, We)
    i0i = jnp.clip(i0.astype(jnp.int32), 0, He - 1)
    i1i = jnp.clip(i0.astype(jnp.int32) + 1, 0, He - 1)
    taps = (
        (i0i, j0i, (1.0 - tu) * (1.0 - tv)),
        (i0i, j1i, tu * (1.0 - tv)),
        (i1i, j0i, (1.0 - tu) * tv),
        (i1i, j1i, tu * tv),
    )
    tex = jnp.moveaxis(env, -1, 0).reshape(3, He * We)
    acc = sum(table.fetch(tex, ii * We + jj) * w[None, :]
              for ii, jj, w in taps)
    return (acc[0], acc[1], acc[2])


def _env_radiance_spec(scene, d, wavelengths):
    """Envmap radiance along world direction d -> (4, L) spectrum.

    RGB texels are lifted to hero wavelengths with the piecewise-linear
    channel-anchor model (bsdf.kernels.rgb_to_spectral) — the documented
    spectral semantics for RGB-valued data in this framework (the stale
    reference envmap was plain Color3 radiance)."""
    from misaki_tpu.bsdf.kernels import rgb_to_spectral

    u, v, _ = _env_dir_to_uv(scene, d)
    rgb = _env_bilinear_rgb(scene, u, v)
    return jnp.maximum(rgb_to_spectral(rgb, wavelengths), 0.0)


def _env_pdf_sa(scene, u, v, sin_t):
    """Solid-angle pdf of the 2D texel-CDF sampler at (u, v):
    p(omega) = pmf[i, j] * He * We / (2 pi^2 sin(theta))."""
    pmf = scene.emitters.env_pmf
    He, We = pmf.shape
    i = jnp.clip((v * He).astype(jnp.int32), 0, He - 1)
    j = jnp.clip((u * We).astype(jnp.int32), 0, We - 1)
    p = table.fetch(pmf.reshape(1, He * We), i * We + j)[0]
    denom = 2.0 * m.Pi * m.Pi * jnp.maximum(sin_t, 1e-6)
    return p * (He * We) / denom


def _env_sample_dir(scene, u2):
    """2D CDF importance sampling of the lat-long map: row from the marginal
    CDF, column from the row's conditional CDF, sub-texel position by sample
    reuse; pdf converted to solid angle with the sin-theta Jacobian.
    Returns (d toward the environment, solid-angle pdf, u, v)."""
    em = scene.emitters
    He, We = em.env_pmf.shape
    ux, uy = u2

    # --- row: compare-count against the (He,) marginal CDF ---
    marg = em.env_marg_cdf
    below = uy[None, :] > marg[:, None]                     # (He, L)
    r = jnp.clip(jnp.sum(below.astype(jnp.int32), 0), 0, He - 1)
    mlo = jnp.max(jnp.where(below, marg[:, None], 0.0), axis=0)
    mhi = jnp.min(jnp.where(below, 1.0, marg[:, None]), axis=0)
    dv = jnp.clip((uy - mlo) / jnp.maximum(mhi - mlo, 1e-20), 0.0, 1.0 - 1e-6)

    # --- column: gather the row CDF, compare-count ---
    rows = table.fetch(em.env_cond_cdf.T, r)                # (We, L)
    belowc = ux[None, :] > rows
    c = jnp.clip(jnp.sum(belowc.astype(jnp.int32), 0), 0, We - 1)
    clo = jnp.max(jnp.where(belowc, rows, 0.0), axis=0)
    chi = jnp.min(jnp.where(belowc, 1.0, rows), axis=0)
    du = jnp.clip((ux - clo) / jnp.maximum(chi - clo, 1e-20), 0.0, 1.0 - 1e-6)

    u = (c.astype(jnp.float32) + du) / We
    v = (r.astype(jnp.float32) + dv) / He
    d, sin_t = _env_uv_to_dir(scene, u, v)
    pdf = _env_pdf_sa(scene, u, v, sin_t)
    pdf = jnp.where(sin_t > 1e-6, pdf, 0.0)
    return d, pdf, u, v


def _sample_envmap_emitter(scene, ei, ref_p, wavelengths, u2, rad=None):
    """Direct sampling of the envmap via the shared 2D-CDF direction
    sampler (_env_sample_dir)."""
    em = scene.emitters
    L = u2[0].shape[0]
    d, pdf, u, v = _env_sample_dir(scene, u2)

    from misaki_tpu.bsdf.kernels import rgb_to_spectral

    rgb = _env_bilinear_rgb(scene, u, v)
    rad_tex = jnp.maximum(rgb_to_spectral(rgb, wavelengths), 0.0)
    spec = jnp.where(
        (pdf > 0.0)[None, :], rad_tex / jnp.maximum(pdf, 1e-20)[None, :], 0.0
    )
    dist = jnp.full((L,), 2.0 * em.bsphere_radius)
    return {"d": d, "dist": dist, "pdf": pdf, "spec": spec}


def eval_environment(scene, d, wavelengths, rad=None):
    """Environment radiance along escaped direction d (constant.cpp eval /
    envmap lat-long lookup)."""
    if not scene.has_environment:
        return jnp.zeros(wavelengths.shape)
    if scene.emitter_kinds[scene.environment_idx] == EM_ENVMAP:
        return _env_radiance_spec(scene, d, wavelengths)
    return radiance(scene, scene.environment_idx, wavelengths, rad)


def _sample_area_emitter(scene, ei, ref_p, wavelengths, u2, rad=None):
    """Area-light direct sampling: area-uniform position on the emissive
    shape (mesh.cpp:103-133) converted to solid angle (shape.cpp:66-80),
    one-sided (area.cpp:38-45)."""
    em = scene.emitters
    cdf = em.face_cdf[ei]     # (Fmax,) — static row slice

    # face pick by area CDF with sample reuse (distribution.h sample_reuse):
    # a single vectorized compare-count over the padded CDF row (one (Fmax, L)
    # broadcast — no per-face Python unroll, trace size is O(1) in Fmax),
    # then ONE gather from the compact per-emitter face pack (EF_COLS, Fmax)
    # with the bracketing CDF values and the face columns the sampler needs.
    uy = u2[1]
    fmax = cdf.shape[0]
    below = uy[None, :] > cdf[:, None]                      # (Fmax, L)
    idx = jnp.clip(jnp.sum(below.astype(jnp.int32), 0), 0, fmax - 1)
    fd = table.fetch(em.face_pack[ei], idx)                 # (EF_COLS, L)
    lo, hi = fd[EF_CDF_LO], fd[EF_CDF_HI]
    uy = jnp.clip((uy - lo) / jnp.maximum(hi - lo, 1e-20), 0.0, 1.0 - 1e-7)

    b1, b2 = warp.square_to_uniform_triangle((u2[0], uy))
    b0 = 1.0 - b1 - b2

    p0 = (fd[EF_P0], fd[EF_P0 + 1], fd[EF_P0 + 2])
    e1 = (fd[EF_E1], fd[EF_E1 + 1], fd[EF_E1 + 2])
    e2 = (fd[EF_E2], fd[EF_E2 + 1], fd[EF_E2 + 2])
    p = vec.add(p0, vec.add(vec.scale(e1, b1), vec.scale(e2, b2)))
    ng = (fd[EF_NG], fd[EF_NG + 1], fd[EF_NG + 2])
    n0 = (fd[EF_N0], fd[EF_N0 + 1], fd[EF_N0 + 2])
    n1 = (fd[EF_N0 + 3], fd[EF_N0 + 4], fd[EF_N0 + 5])
    n2 = (fd[EF_N0 + 6], fd[EF_N0 + 7], fd[EF_N0 + 8])
    ns = vec.normalize(
        vec.add(vec.scale(n0, b0), vec.add(vec.scale(n1, b1), vec.scale(n2, b2)))
    )
    n = vec.where(fd[EF_HAS_N] > 0.5, ns, ng)

    d = vec.sub(p, ref_p)
    dist2 = vec.norm2(d)
    dist = jnp.sqrt(dist2)
    d = vec.scale(d, 1.0 / jnp.maximum(dist, 1e-20))

    pdf_area = 1.0 / jnp.maximum(em.area[ei], 1e-20)
    dn = vec.dot(d, n)
    dp = jnp.abs(dn)
    pdf = jnp.where(dp != 0.0, pdf_area * dist2 / jnp.maximum(dp, 1e-20), 0.0)

    # one-sided emission: only where d . n < 0 (area.cpp:38)
    pdf = jnp.where(dn < 0.0, pdf, 0.0)
    rad_s = radiance(scene, ei, wavelengths, rad)
    spec = jnp.where(
        (pdf > 0.0)[None, :], rad_s / jnp.maximum(pdf, 1e-20)[None, :], 0.0
    )
    return {"d": d, "dist": dist, "pdf": pdf, "spec": spec}


def _sample_constant_emitter(scene, ei, ref_p, wavelengths, u2, rad=None):
    """Uniform-sphere env sampling (constant.cpp:53-74)."""
    em = scene.emitters
    d = warp.square_to_uniform_sphere(u2)
    L = d[0].shape[0]
    dist = jnp.full((L,), 2.0 * em.bsphere_radius)
    pdf = warp.square_to_uniform_sphere_pdf(d)
    rad_s = radiance(scene, ei, wavelengths, rad)
    return {"d": d, "dist": dist, "pdf": pdf, "spec": rad_s / pdf[None, :]}


def _sample_point_emitter(scene, ei, ref_p, wavelengths, u2, rad=None):
    """Delta position light, 1/r^2 falloff (stale emitters/point.cpp parity)."""
    em = scene.emitters
    p = em.position[ei]
    d = vec.sub(vec.splat3(p, ref_p[0]), ref_p)
    dist2 = vec.norm2(d)
    dist = jnp.sqrt(dist2)
    d = vec.scale(d, 1.0 / jnp.maximum(dist, 1e-20))
    rad_s = radiance(scene, ei, wavelengths, rad)
    return {
        "d": d,
        "dist": dist,
        "pdf": jnp.ones_like(dist),
        "spec": rad_s / jnp.maximum(dist2, 1e-20)[None, :],
    }


def sample_emitter_direct(scene, ref_p, wavelengths, u2, rad=None):
    """Scene::sample_emitter_direct (scene.cpp:68-103) minus the visibility
    test (the integrator casts the batched shadow ray).

    Uniform emitter pick with sample reuse; returns SoA dict
    {d (vec3), dist, pdf, spec (4, L), delta} — spec = radiance/pdf (and the
    selection count factor); pdf includes the selection pdf."""
    n = scene.n_emitters
    L = ref_p[0].shape[0]
    if n == 0:
        z = jnp.zeros(L)
        return {
            "d": (z, z, z),
            "dist": z,
            "pdf": z,
            "spec": jnp.zeros((4, L)),
            "delta": jnp.zeros(L, bool),
        }

    ux = u2[0]
    if n == 1:
        index = jnp.zeros(L, jnp.int32)
        ux_r = ux
    else:
        index = jnp.minimum((ux * n).astype(jnp.int32), n - 1)
        ux_r = (ux - index.astype(jnp.float32) / n) * n
    u2r = (ux_r, u2[1])

    samplers = {
        EM_AREA: _sample_area_emitter,
        EM_CONSTANT: _sample_constant_emitter,
        EM_POINT: _sample_point_emitter,
        EM_ENVMAP: _sample_envmap_emitter,
    }
    kinds = scene.emitter_kinds
    out = None
    delta = jnp.zeros(L, bool)
    for ei in range(n):
        r = samplers[kinds[ei]](scene, ei, ref_p, wavelengths, u2r, rad)
        mask = index == ei
        if out is None:
            out = r
        else:
            out = {
                "d": vec.where(mask, r["d"], out["d"]),
                "dist": jnp.where(mask, r["dist"], out["dist"]),
                "pdf": jnp.where(mask, r["pdf"], out["pdf"]),
                "spec": jnp.where(mask[None, :], r["spec"], out["spec"]),
            }
        delta = delta | (mask & (kinds[ei] == EM_POINT))

    if n > 1:
        out["pdf"] = out["pdf"] * (1.0 / n)
        out["spec"] = out["spec"] * n
    out["delta"] = delta
    return out


def sample_emitter_ray(scene, wavelengths, u_sel, u_pos, u_dir, rad=None):
    """Emitter::sample_ray for the photon-tracing pass
    (integrators/{sppm,photonmapper}.cpp photon loop). The reference's
    area-light implementation is `MSK_NOT_IMPLEMENTED` (area.cpp:20-29 —
    upstream SPPM cannot actually run); we implement the commented-out
    intent: area-uniform position, cosine-weighted direction, flux =
    Le * pi / pdf_pos (so that flux integrates to emitted power), times the
    1/sel_pdf emitter-count factor applied by the callers there.

    Returns {o, d (vec3), n (vec3 surface normal; d for point lights),
    flux (4, L), valid (L,)}. Infinite emitters (constant / envmap) use the
    standard bounding-disk sampler (the reference never had one —
    sppm.cpp:233-260 pre-dates its envmap): pick an inward direction w
    (uniform sphere, or the envmap's 2D texel CDF), then a point on the
    scene-bsphere-radius disk perpendicular to w tangent to the bsphere;
    flux = Le(w) * pi r^2 / pdf_dir (disk position pdf 1/(pi r^2) cancels
    the disk area)."""
    n = scene.n_emitters
    L = u_sel.shape[0]
    z = jnp.zeros(L)
    out = {
        "o": (z, z, z), "d": (z, z, 1.0 + z), "n": (z, z, 1.0 + z),
        "flux": jnp.zeros((4, L)), "valid": jnp.zeros(L, bool),
    }
    if n == 0:
        return out
    index = jnp.minimum((u_sel * n).astype(jnp.int32), n - 1)
    for ei in range(n):
        kind = scene.emitter_kinds[ei]
        mask = index == ei
        if kind == EM_AREA:
            em = scene.emitters
            cdf = em.face_cdf[ei]
            uy = u_pos[1]
            fmax = cdf.shape[0]
            below = uy[None, :] > cdf[:, None]
            idx = jnp.clip(jnp.sum(below.astype(jnp.int32), 0), 0, fmax - 1)
            fd = table.fetch(em.face_pack[ei], idx)
            lo, hi = fd[EF_CDF_LO], fd[EF_CDF_HI]
            uy = jnp.clip((uy - lo) / jnp.maximum(hi - lo, 1e-20),
                          0.0, 1.0 - 1e-7)
            b1, b2 = warp.square_to_uniform_triangle((u_pos[0], uy))
            p0 = (fd[EF_P0], fd[EF_P0 + 1], fd[EF_P0 + 2])
            e1 = (fd[EF_E1], fd[EF_E1 + 1], fd[EF_E1 + 2])
            e2 = (fd[EF_E2], fd[EF_E2 + 1], fd[EF_E2 + 2])
            p = vec.add(p0, vec.add(vec.scale(e1, b1), vec.scale(e2, b2)))
            ng = vec.normalize((fd[EF_NG], fd[EF_NG + 1], fd[EF_NG + 2]))
            fr = frame.make_frame(ng)
            d_local = warp.square_to_cosine_hemisphere(u_dir)
            d = frame.to_world(fr, d_local)
            # flux = Le * pi * area (pdf_pos = 1/area; the cosine direction
            # pdf cos/pi cancels the emitted cos * 1/pi exactly)
            amp = m.Pi * em.area[ei]
            flux = radiance(scene, ei, wavelengths, rad) * amp
            out["o"] = vec.where(mask, p, out["o"])
            out["d"] = vec.where(mask, d, out["d"])
            out["n"] = vec.where(mask, ng, out["n"])
            out["flux"] = jnp.where(mask[None, :], flux, out["flux"])
            out["valid"] = out["valid"] | mask
        elif kind == EM_POINT:
            em = scene.emitters
            p = vec.splat3(em.position[ei], z)
            d = warp.square_to_uniform_sphere(u_dir)
            # radiance() stores the intensity I; flux = 4*pi*I
            flux = radiance(scene, ei, wavelengths, rad) * (4.0 * m.Pi)
            out["o"] = vec.where(mask, p, out["o"])
            out["d"] = vec.where(mask, d, out["d"])
            out["n"] = vec.where(mask, d, out["n"])
            out["flux"] = jnp.where(mask[None, :], flux, out["flux"])
            out["valid"] = out["valid"] | mask
        elif kind in (EM_CONSTANT, EM_ENVMAP):
            em = scene.emitters
            if kind == EM_ENVMAP:
                d_env, pdf_dir, u, v = _env_sample_dir(scene, u_dir)
                from misaki_tpu.bsdf.kernels import rgb_to_spectral

                rgb = _env_bilinear_rgb(scene, u, v)
                le = jnp.maximum(rgb_to_spectral(rgb, wavelengths), 0.0)
            else:
                d_env = warp.square_to_uniform_sphere(u_dir)
                pdf_dir = warp.square_to_uniform_sphere_pdf(d_env)
                le = radiance(scene, ei, wavelengths, rad)
            w = vec.neg(d_env)                   # photon travel direction
            r = jnp.maximum(em.bsphere_radius, 1e-4)
            fr = frame.make_frame(w)
            dx, dy = warp.square_to_uniform_disk_concentric(u_pos)
            c = vec.splat3(em.bsphere_center, z)
            o = vec.add(
                vec.add(c, vec.scale(d_env, r)),
                vec.add(vec.scale(fr["s"], dx * r), vec.scale(fr["t"], dy * r)),
            )
            ok = pdf_dir > 0.0
            flux = jnp.where(
                ok[None, :],
                le * (m.Pi * r * r) / jnp.maximum(pdf_dir, 1e-20)[None, :],
                0.0,
            )
            out["o"] = vec.where(mask, o, out["o"])
            out["d"] = vec.where(mask, w, out["d"])
            out["n"] = vec.where(mask, w, out["n"])
            out["flux"] = jnp.where(mask[None, :], flux, out["flux"])
            out["valid"] = out["valid"] | (mask & ok)
    if n > 1:
        out["flux"] = out["flux"] * n  # 1 / (uniform selection pdf)
    return out


def pdf_emitter_direct(scene, emitter_ids, d, dist, n_at_hit):
    """Scene::pdf_emitter_direct (scene.cpp:105-112) for MIS when a BSDF ray
    hits an emitter. Area: (1/area) * dist^2/|d.n| (shape.cpp:82-88);
    constant env: uniform-sphere pdf. Unrolled statically per emitter."""
    L = dist.shape[0]
    pdf = jnp.zeros(L)
    dp = jnp.abs(vec.dot(d, n_at_hit))
    for ei in range(scene.n_emitters):
        kind = scene.emitter_kinds[ei]
        mask = emitter_ids == ei
        if kind == EM_AREA:
            p_area = jnp.where(
                dp != 0.0,
                (1.0 / jnp.maximum(scene.emitters.area[ei], 1e-20))
                * dist * dist / jnp.maximum(dp, 1e-20),
                0.0,
            )
            pdf = jnp.where(mask, p_area, pdf)
        elif kind == EM_CONSTANT:
            pdf = jnp.where(mask, m.InvFourPi, pdf)
        elif kind == EM_ENVMAP:
            u, v, sin_t = _env_dir_to_uv(scene, d)
            pdf = jnp.where(
                mask & (sin_t > 1e-6), _env_pdf_sa(scene, u, v, sin_t), pdf
            )
    if scene.n_emitters > 1:
        pdf = pdf / scene.n_emitters
    return jnp.where(emitter_ids >= 0, pdf, 0.0)
