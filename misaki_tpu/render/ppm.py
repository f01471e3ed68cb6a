"""Wavefront photon mapping: the `sppm` and `photonmapper` integrators
(reference: src/librender/integrators/sppm.cpp:1-356 and
photonmapper.cpp:1-250) re-designed for dense lockstep execution.

The reference builds pointer-chased structures — SPPM hashes visible points
into a linked-list grid guarded by CAS loops and atomic floats
(sppm.cpp:183-230), the photonmapper a nanoflann kd-tree
(photonmapper.cpp:30-62) — none of which map onto lockstep wavefronts.
Here BOTH passes are the existing wavefront machinery, and density
estimation is a *blocked dense all-pairs reduction*: photon blocks stream
against every visible point at once, the within-radius/hemisphere mask is a
(B, L) vector op, and the flux sum is one (4, B) x (B, L) matmul per
block — the same scatter-free pattern as the film splat. No tree, no hash,
no atomics; bit-deterministic by construction.

Differences from the reference (documented, deliberate):
  * The reference's area-emitter `sample_ray` is MSK_NOT_IMPLEMENTED
    (area.cpp:20-29), so upstream SPPM cannot run on area lights at all; we
    implement its commented-out intent (emitter/kernels.sample_emitter_ray).
  * Spectral transport: each iteration draws ONE shared hero-wavelength set
    for camera and photon paths (the reference is RGB); per-pixel state
    (value/tau) accumulates in XYZ across iterations, which keeps the
    estimator consistent as wavelengths rotate.
  * Visible points are stored at diffuse-lobe hits (diffuse / roughplastic
    rows); in sppm mode the reference additionally parks *glossy* visible
    points when the camera path hits the depth cap (sppm.cpp:146-151) and
    evaluates their full BSDF pairwise at the photon's frame
    (sppm.cpp:263-268: wi = photon's local incoming, wo = photon-frame
    projection of vp.wi, f divided by cos_theta(wo)) — implemented here as
    a vmapped per-pair eval over GLOSSY_BLOCK photon sub-blocks
    (_density_blocks_glossy), traced only when the scene has glossy lobes.
    Note the dense form pays O(photons x pixels) GGX evals — fine at
    photon-mapping budgets, but the dominant cost when it triggers.
  * The photonmapper shares the SPPM loop with a fixed radius and no
    radius shrink: `iterations` camera passes each retrace `photon_count`
    photons (the reference traces one global map and takes a single camera
    sample per pixel, photonmapper.cpp:72-121; at iterations=1 the two
    agree, and more iterations simply converge the same estimator).
"""

from functools import partial

import jax
import jax.numpy as jnp

from misaki_tpu.core import frame, math as m, rng, spectrum as spec, vec
from misaki_tpu.render import camera as cam
from misaki_tpu.render import film as film_mod
from misaki_tpu.render import interaction as inter
from misaki_tpu.accel import traverse
from misaki_tpu.bsdf import kernels as bsdf
from misaki_tpu.emitter import kernels as emitter
from misaki_tpu.scene.types import (
    BSDF_DIFFUSE,
    BSDF_DISNEY,
    BSDF_PLASTIC,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_DIELECTRIC,
)

PHOTON_BLOCK = 2048  # photons per dense density-estimation block
# photons per GLOSSY pair-eval sub-block (each costs a (GLOSSY_BLOCK, 4, L)
# BSDF-eval intermediate — kept small so XLA can stream the reduction)
import os as _os

GLOSSY_BLOCK = int(_os.environ.get("MISAKI_PPM_GLOSSY_BLOCK", 64))

_GLOSSY_KINDS = (BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, BSDF_DISNEY)


def _depth_budget(scene, depth_cap):
    d = scene.max_depth if scene.max_depth > 0 else depth_cap + 1
    return max(min(d, depth_cap + 1), 1)


def _diffuse_vp_mask(kind, kinds):
    ok = jnp.zeros_like(kind, dtype=bool)
    if BSDF_DIFFUSE in kinds:
        ok = ok | (kind == BSDF_DIFFUSE)
    if BSDF_PLASTIC in kinds:
        ok = ok | (kind == BSDF_PLASTIC)
    return ok


def _glossy_vp_mask(kind, kinds):
    ok = jnp.zeros_like(kind, dtype=bool)
    for k in _GLOSSY_KINDS:
        if k in kinds:
            ok = ok | (kind == k)
    return ok


def _has_glossy(kinds):
    return any(k in kinds for k in _GLOSSY_KINDS)


def _where_tree(mask, new, old):
    """Masked merge of a material-params dict (nested dicts of lane arrays;
    static entries — kind tuples, python bools, None — pass through)."""
    if new is None or old is None:
        return new
    if isinstance(new, dict):
        return {k: _where_tree(mask, new[k], old.get(k)) for k in new}
    if isinstance(new, (tuple, bool, int, float, str)):
        return new  # static config (e.g. p["kinds"], p["diff"])
    arr = jnp.asarray(new)
    m = mask[None, :] if arr.ndim == 2 else mask
    return jnp.where(m, arr, old)


def _zero_tree(p):
    """Zero-filled skeleton matching a material-params dict (statics kept)."""
    if p is None:
        return None
    if isinstance(p, dict):
        return {k: _zero_tree(v) for k, v in p.items()}
    if isinstance(p, (tuple, bool, int, float, str)):
        return p
    return jnp.zeros_like(p)


def _camera_pass(scene, it, seed, wavelengths, wav_weight, depth_budget,
                 sppm_mode, rad):
    """One 1-sample-per-pixel camera pass. Returns per-pixel:
    value (4, L) — emitter/env/NEE radiance for this iteration, and the
    visible-point record {p, wi (world), n, beta, rho, valid}."""
    W, H = scene.film_width, scene.film_height
    L = W * H
    lane = jnp.arange(L, dtype=jnp.uint32)
    state = make_state = rng.seed(
        (jnp.uint32(seed) * jnp.uint32(0x9E3779B9) + it, lane),
        (lane ^ (it * jnp.uint32(0x85EBCA6B)), jnp.uint32(seed) | jnp.uint32(1)),
    )
    del make_state
    jitter, state = rng.next_2d(state)
    px = (lane % W).astype(jnp.float32) + jitter[0]
    py = (lane // W).astype(jnp.float32) + jitter[1]
    ray = cam.sample_ray(
        scene.camera, (px + scene.crop_x, py + scene.crop_y), jnp.zeros(L)
    )
    o, d = ray["o"], ray["d"]

    hit = traverse.intersect(scene, o, d, ray["mint"], ray["maxt"])
    si = inter.compute_interaction(scene, hit, o, d, wavelengths)
    # camera-ray coverage drives alpha (advisor r4 #4): purely specular /
    # glossy geometry and directly-visible emitters never store a visible
    # point, but they ARE covered — match the path integrators' semantics
    primary_hit = si["valid"]

    value = jnp.zeros((4, L))
    beta = jnp.ones((4, L))
    active = si["valid"]
    specular = jnp.zeros(L, bool)
    glossy_vps = sppm_mode and _has_glossy(scene.bsdf_kinds)
    vp = {
        "p": (jnp.zeros(L), jnp.zeros(L), jnp.zeros(L)),
        "wi": (jnp.zeros(L), jnp.zeros(L), jnp.ones(L)),
        "n": (jnp.zeros(L), jnp.zeros(L), jnp.ones(L)),
        "beta": jnp.zeros((4, L)),
        "rho": jnp.zeros((4, L)),
        "valid": jnp.zeros(L, bool),
        # glossy visible points (sppm.cpp:146-151): parked at the depth cap,
        # evaluated pairwise with the stored material params (mat)
        "glossy": jnp.zeros(L, bool),
        "mat": None,
    }
    if scene.has_environment and not scene.hide_emitters:
        env = emitter.eval_environment(scene, d, wavelengths, rad)
        value = value + jnp.where((~si["valid"])[None, :], env, 0.0)

    kinds = scene.bsdf_kinds
    for depth in range(depth_budget):
        # emitted radiance: first hit, or any hit reached through a delta
        # chain (sppm.cpp:121-124)
        em_ok = active & (si["emitter"] >= 0)
        see_emitter = em_ok if depth == 0 else (em_ok & specular)
        if not scene.hide_emitters or depth > 0:
            em_val = emitter.eval_emitter(
                scene, si["emitter"], si["wi"], si["uv"], wavelengths, rad
            )
            value = value + jnp.where(
                see_emitter[None, :], beta * em_val, 0.0
            )

        p = bsdf.material_params(scene, si["bsdf"], si["uv"], wavelengths,
                                 duv=(si["duv_dx"], si["duv_dy"]))

        if sppm_mode:
            # visibility-tested light sampling at every Smooth vertex
            # (sppm.cpp:126-144; photons at depth > 0 carry the indirect
            # part, so there is no MIS and no double count)
            u_nee, state = rng.next_2d(state)
            ds = emitter.sample_emitter_direct(
                scene, si["p"], wavelengths, u_nee, rad
            )
            possible = active & p["smooth"] & (ds["pdf"] > 0.0)
            sh_mint = m.RayEpsilon * (1.0 + vec.max_abs(si["p"]))
            occ = traverse.ray_test(
                scene, si["p"], ds["d"],
                jnp.where(possible, sh_mint, 0.0),
                jnp.where(possible, ds["dist"] * (1.0 - m.ShadowEpsilon),
                          -1.0),
            )
            wo_nee = frame.to_local(si["sh"], ds["d"])
            f_nee = bsdf.eval_bsdf(p, si["wi"], wo_nee)
            value = value + jnp.where(
                (possible & ~occ)[None, :], beta * ds["spec"] * f_nee, 0.0
            )

        # park the visible point at the first diffuse-lobe hit — only on a
        # side the camera can shade (one-sided lobes seen from behind must
        # NOT collect photons through the surface; the path tracer's eval
        # returns 0 there), with the normal flipped to the camera side for
        # twosided materials so the photon cos tests match the flip
        is_diffuse = _diffuse_vp_mask(p["kind"], kinds)
        front = frame.cos_theta(si["wi"]) > 0.0
        shadeable = front | p["twosided"]
        store = active & is_diffuse & shadeable & ~vp["valid"]
        n_sh = vec.where(front, si["sh"]["n"], vec.neg(si["sh"]["n"]))
        # ... and, in sppm mode, a GLOSSY visible point when the camera path
        # hits the depth cap on a glossy lobe (sppm.cpp:146-151): the pair
        # sum then evaluates the stored full BSDF instead of rho/pi
        store_g = jnp.zeros_like(store)
        if glossy_vps and depth == depth_budget - 1:
            store_g = (active & _glossy_vp_mask(p["kind"], kinds)
                       & shadeable & ~vp["valid"])
        store_any = store | store_g
        vp = {
            "p": vec.where(store_any, si["p"], vp["p"]),
            "wi": vec.where(store_any, vec.neg(d), vp["wi"]),
            "n": vec.where(store_any, n_sh, vp["n"]),
            "beta": jnp.where(store_any[None, :], beta, vp["beta"]),
            # rho stays 0 on glossy lanes: the diffuse matmul path zeroes out
            "rho": jnp.where(store[None, :], p["reflectance"], vp["rho"]),
            "valid": vp["valid"] | store_any,
            "glossy": vp["glossy"] | store_g,
            "mat": vp["mat"],
        }
        if glossy_vps:
            if vp["mat"] is None:
                vp["mat"] = _zero_tree(p)
            vp["mat"] = _where_tree(store_g, p, vp["mat"])
        active = active & ~store_any

        if depth == depth_budget - 1:
            break

        # continue the path through non-diffuse lobes (sppm.cpp:153-174)
        u1, state = rng.next_float32(state)
        u2, state = rng.next_2d(state)
        u_rr, state = rng.next_float32(state)
        bs = bsdf.sample_bsdf(p, si["wi"], u1, u2)
        active = active & bs["valid"] & (bs["pdf"] > 0.0)
        beta_new = beta * bs["weight"]
        q = jnp.minimum(jnp.max(beta_new, axis=0), 0.95)
        kill = u_rr >= q
        active = active & ~kill
        beta = jnp.where(
            active[None, :], beta_new / jnp.maximum(q, 1e-8)[None, :], beta
        )
        specular = bs["delta"]
        wo_world = frame.to_world(si["sh"], bs["wo"])
        new_mint = inter.spawn_ray_mint(si["p"])
        hit = traverse.intersect(
            scene, si["p"], wo_world,
            jnp.where(active, new_mint, 0.0),
            jnp.where(active, jnp.inf, -1.0),
        )
        env_escape = active & (hit["prim"] < 0)
        if scene.has_environment and not scene.hide_emitters:
            env = emitter.eval_environment(scene, wo_world, wavelengths, rad)
            value = value + jnp.where(env_escape[None, :], beta * env, 0.0)
        si = inter.compute_interaction(scene, hit, si["p"], wo_world,
                                       wavelengths)
        o, d = si["p"], wo_world  # d only used for vp.wi storage
        active = active & si["valid"]

    return value, vp, primary_hit


def _density_blocks(vp, radius2, ph_p, ph_wi, ph_n, ph_flux, ph_ok,
                    sppm_mode):
    """Blocked all-pairs density estimation of one photon-depth record
    against every visible point. Returns (phi_flux (4, L), m_count (L,)).

    Pair (photon j, vp i) contributes flux_j when |p_i - p_j|^2 < r_i^2 and
    the transport hemisphere checks pass. SPPM evaluates the vp BSDF at the
    *photon's* frame (sppm.cpp:263-268: wo = photon_si.to_local(vp.wi)),
    the photonmapper at the vp's own frame (photonmapper.cpp:227-233) —
    for the diffuse lobe both reduce to rho/pi times hemisphere tests; the
    rho_i/pi factor is applied by the caller (it is per-vp, outside the
    pair sum). The flux sum over a block is one (4, B) x (B, L) matmul."""
    L = radius2.shape[0]
    P = ph_ok.shape[0]
    nb = -(-P // PHOTON_BLOCK)

    # photon-side constant per photon: incoming direction above its surface
    wiz = (ph_wi[0] * ph_n[0] + ph_wi[1] * ph_n[1] + ph_wi[2] * ph_n[2])

    def body(b, carry):
        phi, mc = carry
        s = b * PHOTON_BLOCK
        sl = lambda a: jax.lax.dynamic_slice(a, (s,), (PHOTON_BLOCK,))
        px, py_, pz = sl(ph_p[0]), sl(ph_p[1]), sl(ph_p[2])
        wx, wy, wz = sl(ph_wi[0]), sl(ph_wi[1]), sl(ph_wi[2])
        ok = sl(ph_ok) & (sl(wiz) > 0.0)
        fx = jnp.stack([sl(ph_flux[c]) for c in range(4)], axis=0)  # (4, B)

        dx = px[:, None] - vp["p"][0][None, :]          # (B, L)
        dy = py_[:, None] - vp["p"][1][None, :]
        dz = pz[:, None] - vp["p"][2][None, :]
        d2 = dx * dx + dy * dy + dz * dz
        within = d2 < radius2[None, :]
        if sppm_mode:
            # cos(photon frame, vp.wi) > 0: photon's normal vs vp camera dir
            nx, ny, nz = sl(ph_n[0]), sl(ph_n[1]), sl(ph_n[2])
            cosw = (nx[:, None] * vp["wi"][0][None, :]
                    + ny[:, None] * vp["wi"][1][None, :]
                    + nz[:, None] * vp["wi"][2][None, :])
        else:
            # cos(vp frame, photon.wi) > 0: vp normal vs photon incoming
            cosw = (wx[:, None] * vp["n"][0][None, :]
                    + wy[:, None] * vp["n"][1][None, :]
                    + wz[:, None] * vp["n"][2][None, :])
        mask = (within & (cosw > 0.0) & ok[:, None]
                & (vp["valid"] & ~vp["glossy"])[None, :]).astype(jnp.float32)
        # HIGHEST: a float32 dot may otherwise run in TF32 on GPUs, which
        # rounds the photon flux to ~3 decimal digits
        phi = phi + jax.lax.dot_general(
            fx, mask, dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        mc = mc + jnp.sum(mask, axis=0)
        return phi, mc

    init = (jnp.zeros((4, L)), jnp.zeros(L))
    if nb == 1:
        return body(0, init)
    return jax.lax.fori_loop(0, nb, body, init)


def _density_blocks_glossy(vp, radius2, ph_p, ph_sh, ph_wi_local, ph_flux,
                           ph_ok):
    """Pairwise full-BSDF density estimation for GLOSSY visible points
    (sppm.cpp:263-268): the vp's stored BSDF is evaluated at the PHOTON's
    shading frame — wi = the photon's local incoming direction, wo = the
    photon-frame projection of vp.wi — and divided by cos_theta(wo), exactly
    the reference pair term (for diffuse lobes this reduces to rho/pi, which
    is what the dense matmul path computes). Each photon needs its own
    (4, L) eval, so the block is vmapped over GLOSSY_BLOCK-photon chunks
    instead of the single matmul. Returns (phi (4, L), m (L,))."""
    L = radius2.shape[0]
    P = ph_ok.shape[0]
    nb = -(-P // GLOSSY_BLOCK)
    gl = vp["valid"] & vp["glossy"]
    mat = vp["mat"]
    wi_cam = vp["wi"]  # world-space camera direction at the vp

    def one_photon(ph):
        sh = ph["sh"]
        wo = (
            sh["s"][0] * wi_cam[0] + sh["s"][1] * wi_cam[1]
            + sh["s"][2] * wi_cam[2],
            sh["t"][0] * wi_cam[0] + sh["t"][1] * wi_cam[1]
            + sh["t"][2] * wi_cam[2],
            sh["n"][0] * wi_cam[0] + sh["n"][1] * wi_cam[1]
            + sh["n"][2] * wi_cam[2],
        )                                           # (L,) each
        wi = tuple(jnp.broadcast_to(c, (L,)) for c in ph["wi"])
        f = bsdf.eval_bsdf(mat, wi, wo)             # (4, L) = f * cos(wo)
        cz = wo[2]
        safe = jnp.abs(cz) > 1e-4
        f = jnp.where(safe[None, :], f / jnp.where(safe, cz, 1.0)[None, :],
                      0.0)
        dx = ph["p"][0] - vp["p"][0]
        dy = ph["p"][1] - vp["p"][1]
        dz = ph["p"][2] - vp["p"][2]
        within = dx * dx + dy * dy + dz * dz < radius2
        pair = within & gl & ph["ok"]
        contrib = jnp.where(pair[None, :], f * ph["flux"][:, None], 0.0)
        m = (pair & (jnp.max(jnp.abs(f), axis=0) > 0.0)).astype(jnp.float32)
        return contrib, m

    def body(b, carry):
        phi, mc = carry
        s = b * GLOSSY_BLOCK
        sl = lambda a: jax.lax.dynamic_slice(a, (s,), (GLOSSY_BLOCK,))
        ph = {
            "p": tuple(sl(c) for c in ph_p),
            "wi": tuple(sl(c) for c in ph_wi_local),
            "sh": {k: tuple(sl(c) for c in ph_sh[k]) for k in ("s", "t", "n")},
            "flux": jnp.stack([sl(ph_flux[c]) for c in range(4)], axis=1),
            "ok": sl(ph_ok),
        }
        contrib, m = jax.vmap(one_photon)(ph)       # (GB, 4, L), (GB, L)
        return phi + jnp.sum(contrib, axis=0), mc + jnp.sum(m, axis=0)

    init = (jnp.zeros((4, L)), jnp.zeros(L))
    if nb == 1:
        return body(0, init)
    return jax.lax.fori_loop(0, nb, body, init)


def _photon_pass(scene, it, seed, wavelengths, vp, radius2, depth_budget,
                 sppm_mode, rad):
    """Trace `scene.ppm_photons` photons and splat them against the visible
    points depth-by-depth (no photon storage beyond the live wavefront).
    Returns (phi_flux (4, L), m_count (L,))."""
    P = -(-scene.ppm_photons // PHOTON_BLOCK) * PHOTON_BLOCK
    lane = jnp.arange(P, dtype=jnp.uint32)
    # the shared hero-wavelength set, re-broadcast to photon lanes (the
    # camera/photon wavefronts have different lane counts)
    wavelengths = jnp.broadcast_to(wavelengths[:, :1], (4, P))
    rad = emitter.radiance_all(scene, wavelengths)
    state = rng.seed(
        (jnp.uint32(seed) * jnp.uint32(0x6C078965) + it,
         lane + jnp.uint32(0x400000)),
        (lane ^ (it * jnp.uint32(0xB5297A4D)),
         jnp.uint32(seed) | jnp.uint32(1)),
    )
    u_sel, state = rng.next_float32(state)
    u_pos, state = rng.next_2d(state)
    u_dir, state = rng.next_2d(state)
    er = emitter.sample_emitter_ray(scene, wavelengths, u_sel, u_pos, u_dir,
                                    rad)
    o, d, flux = er["o"], er["d"], er["flux"]
    alive = er["valid"]
    L = radius2.shape[0]
    phi = jnp.zeros((4, L))
    phi_g = jnp.zeros((4, L))  # glossy-vp pair sums (full-BSDF estimator)
    mc = jnp.zeros(L)
    glossy = sppm_mode and vp.get("mat") is not None

    mint0 = m.RayEpsilon * (1.0 + vec.max_abs(o))
    hit = traverse.intersect(
        scene, o, d,
        jnp.where(alive, mint0, 0.0),
        jnp.where(alive, jnp.inf, -1.0),
    )
    si = inter.compute_interaction(scene, hit, o, d, wavelengths)
    alive = alive & si["valid"]

    for depth in range(depth_budget):
        # SPPM splats only scattered (depth > 0) photons — camera NEE covers
        # direct light (sppm.cpp:245-248); the photonmapper splats all
        # depths (its camera pass has no NEE, photonmapper.cpp:133-138)
        if sppm_mode and depth == 0:
            pass
        else:
            dphi, dmc = _density_blocks(
                vp, radius2, si["p"], vec.neg(d), si["sh"]["n"],
                tuple(flux[c] for c in range(4)), alive, sppm_mode,
            )
            phi, mc = phi + dphi, mc + dmc
            if glossy:
                gphi, gmc = _density_blocks_glossy(
                    vp, radius2, si["p"], si["sh"], si["wi"],
                    tuple(flux[c] for c in range(4)), alive,
                )
                phi_g, mc = phi_g + gphi, mc + gmc

        if depth == depth_budget - 1:
            break
        p = bsdf.material_params(scene, si["bsdf"], si["uv"], wavelengths)
        u1, state = rng.next_float32(state)
        u2, state = rng.next_2d(state)
        u_rr, state = rng.next_float32(state)
        bs = bsdf.sample_bsdf(p, si["wi"], u1, u2)
        alive = alive & bs["valid"] & (bs["pdf"] > 0.0)
        fnew = flux * bs["weight"]
        q = jnp.minimum(jnp.max(fnew, axis=0)
                        / jnp.maximum(jnp.max(flux, axis=0), 1e-20), 0.95)
        alive = alive & (u_rr < q)
        flux = jnp.where(alive[None, :], fnew / jnp.maximum(q, 1e-8)[None, :],
                         flux)
        wo_world = frame.to_world(si["sh"], bs["wo"])
        new_mint = inter.spawn_ray_mint(si["p"])
        hit = traverse.intersect(
            scene, si["p"], wo_world,
            jnp.where(alive, new_mint, 0.0),
            jnp.where(alive, jnp.inf, -1.0),
        )
        d = wo_world
        si = inter.compute_interaction(scene, hit, si["p"], wo_world,
                                       wavelengths)
        alive = alive & si["valid"]

    return phi, phi_g, mc


@partial(jax.jit, static_argnames=("depth_budget", "sppm_mode"),
         donate_argnames=("st",))
def _ppm_iteration(scene, st, it, seed, depth_budget, sppm_mode):
    """One full SPPM iteration: camera pass -> photon pass -> per-pixel
    radius/tau update (sppm.cpp:296-318, gamma = 2/3)."""
    L = st["radius"].shape[0]
    u_wav, _ = rng.next_float32(
        rng.seed((jnp.uint32(0xA511E9B3), it), (seed, jnp.uint32(7)))
    )
    wavelengths, wav_weight = spec.sample_wavelength(jnp.full((L,), u_wav))
    rad = emitter.radiance_all(scene, wavelengths)

    value, vp, primary_hit = _camera_pass(scene, it, seed, wavelengths,
                                          wav_weight, depth_budget,
                                          sppm_mode, rad)
    radius2 = st["radius"] * st["radius"]
    phi, phi_g, mcount = _photon_pass(scene, it, seed, wavelengths, vp,
                                      radius2, depth_budget, sppm_mode, rad)

    # vp-side factors: rho/pi and the path throughput for the diffuse pair
    # sum (see _density_blocks); glossy pairs already carry their full BSDF
    phi_spec = vp["beta"] * (vp["rho"] * m.InvPi * phi + phi_g)

    # hero-wavelength MIS weight, then XYZ accumulation (per-iteration
    # wavelengths rotate, so cross-iteration state must be spectral-free)
    value_xyz = jnp.stack(
        spec.spectrum_to_xyz(value * wav_weight, wavelengths), axis=0
    )
    phi_xyz = jnp.stack(
        spec.spectrum_to_xyz(phi_spec * wav_weight, wavelengths), axis=0
    )

    if sppm_mode:
        gamma = 2.0 / 3.0
        has = mcount > 0.0
        n_new = st["n"] + gamma * mcount
        r_new = jnp.where(
            has,
            st["radius"] * jnp.sqrt(n_new / jnp.maximum(st["n"] + mcount,
                                                        1e-8)),
            st["radius"],
        )
        ratio = jnp.where(has, (r_new * r_new) / jnp.maximum(radius2, 1e-20),
                          1.0)
        tau = (st["tau"] + phi_xyz) * ratio[None, :]
        st = dict(st, tau=tau, n=jnp.where(has, n_new, st["n"]),
                  radius=r_new)
    else:
        st = dict(st, tau=st["tau"] + phi_xyz)
    st = dict(
        st,
        value=st["value"] + value_xyz,
        alpha=st["alpha"] + primary_hit.astype(jnp.float32),
        iters=st["iters"] + 1.0,
    )
    return st


def _ppm_fingerprint(scene, seed, depth_budget):
    """Checkpoint-compatibility identity for an SPPM run (mirrors
    driver._scene_fingerprint; iterations resume at a whole-iteration
    boundary, so only the per-iteration config matters)."""
    return (
        f"ppm|{scene.film_width}x{scene.film_height}|{scene.integrator}"
        f"|{scene.ppm_photons}|{scene.ppm_radius}|{scene.n_faces}"
        f"|{scene.n_emitters}|seed={seed}|budget={depth_budget}"
    )


def render_ppm(scene, seed=0, depth_cap=8, checkpoint_path=None,
               checkpoint_every=8, progress=None):
    """Driver for the sppm / photonmapper integrators. Returns the standard
    render() dict ({"film": None, "rgb", "alpha"}); the per-pixel state
    bypasses the reconstruction filter exactly like the reference, which
    box-accumulates SPPM pixels (sppm.cpp:320-341).

    checkpoint/progress operate per ITERATION (the natural chunk of an SPPM
    run — advisor r4 #5): the full per-pixel state dict is snapshotted, and
    a resumed run replays the remaining iterations bit-identically (each
    iteration's RNG streams are derived from (it, seed))."""
    import os

    import numpy as np

    W, H = scene.film_width, scene.film_height
    L = W * H
    sppm_mode = scene.integrator == "sppm"
    depth_budget = _depth_budget(scene, depth_cap)
    iters = max(int(scene.ppm_iterations), 1)

    r0 = float(scene.ppm_radius)
    if r0 <= 0.0:
        # auto radius: a small fraction of the scene's bounding sphere
        r0 = 0.025 * float(jnp.maximum(scene.emitters.bsphere_radius, 1e-3))

    st = {
        "value": jnp.zeros((3, L)),
        "tau": jnp.zeros((3, L)),
        "n": jnp.zeros(L),
        "radius": jnp.full((L,), r0, jnp.float32),
        "alpha": jnp.zeros(L),
        "iters": jnp.zeros(()),
    }
    start_it = 0
    fingerprint = _ppm_fingerprint(scene, seed, depth_budget)
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        data = np.load(checkpoint_path, allow_pickle=False)
        if str(data["fingerprint"]) == fingerprint:
            st = {k: jnp.asarray(data[k]) for k in st}
            start_it = int(data["next_it"])
            from misaki_tpu.utils.logging import get_logger

            get_logger().info("resuming sppm from %s at iteration %d/%d",
                              checkpoint_path, start_it, iters)
        else:
            from misaki_tpu.utils.logging import get_logger

            get_logger().warning(
                "sppm checkpoint %s does not match this render — starting "
                "fresh", checkpoint_path)

    for it in range(start_it, iters):
        st = _ppm_iteration(scene, st, jnp.uint32(it), jnp.uint32(seed),
                            depth_budget, sppm_mode)
        if progress is not None:
            progress(it + 1, iters)
        if (checkpoint_path is not None and checkpoint_every > 0
                and (it + 1) % checkpoint_every == 0 and it + 1 < iters):
            tmp = f"{checkpoint_path}.tmp.npz"
            np.savez(tmp, fingerprint=np.array(fingerprint),
                     next_it=np.int64(it + 1),
                     **{k: np.asarray(v) for k, v in st.items()})
            os.replace(tmp, checkpoint_path)
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)  # completed: snapshot is stale

    Np = float(iters) * float(-(-scene.ppm_photons // PHOTON_BLOCK)
                              * PHOTON_BLOCK)
    r2 = st["radius"] * st["radius"]
    xyz = st["value"] / float(iters) + st["tau"] / (Np * m.Pi * r2)[None, :]
    img = xyz.T.reshape(H, W, 3)
    rgb = spec.xyz_to_srgb_image(img)
    alpha = (st["alpha"] / float(iters)).reshape(H, W)
    return {"film": None, "rgb": jnp.clip(rgb, 0.0, None), "alpha": alpha}
