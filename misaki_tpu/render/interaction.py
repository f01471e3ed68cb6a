"""SoA scene-interaction computation — barycentric surface records
(reference: src/librender/mesh.cpp:50-101 compute_scene_interaction,
interaction.h spawn_ray / initialize_sh_frame).

Lane-last layout; ALL per-face data arrives via one gather of the packed
face table's columns (core/table.py fetch).
"""

import jax.numpy as jnp

from misaki_tpu.core import frame, math as m, table, vec
from misaki_tpu.scene.types import (
    FC_BSDF,
    FC_E1,
    FC_E2,
    FC_EMITTER,
    FC_HAS_N,
    FC_HAS_UV,
    FC_MED_EXT,
    FC_MED_INT,
    FC_N0,
    FC_NG,
    FC_P0,
    FC_TANGENT,
    FC_UV0,
)


def fetch_face(scene, prim):
    """One gather of all packed face columns -> (C, L); miss lanes
    (prim = -1) get an all-zero row."""
    return table.fetch(scene.geometry.face_tab, prim)


def _rows3(fd, base):
    return (fd[base], fd[base + 1], fd[base + 2])


def _unit_z(like):
    z = jnp.zeros_like(like)
    return (z, z, jnp.ones_like(like))


def _uv_partials(fd, valid, p, o, ng, d_dx, d_dy):
    """Screen-space UV partials (interaction.h:62-85 compute_uv_partials,
    pinhole origin shared): project the +1px neighbour rays onto the hit
    plane, then 2x2 least-squares against the face's UV-parameterization
    tangents dp_du/dp_dv (mesh.cpp:66-80). Returns (duv_dx, duv_dy) 2-tuples
    of (L,); zeros for invalid lanes or degenerate parameterizations."""
    # dp_du/dp_dv from the UV deltas (mesh.cpp:71-80)
    e1 = _rows3(fd, FC_E1)
    e2 = _rows3(fd, FC_E2)
    du0 = fd[FC_UV0 + 2] - fd[FC_UV0]
    dv0 = fd[FC_UV0 + 3] - fd[FC_UV0 + 1]
    du1 = fd[FC_UV0 + 4] - fd[FC_UV0]
    dv1 = fd[FC_UV0 + 5] - fd[FC_UV0 + 1]
    det = du0 * dv1 - dv0 * du1
    ok_uv = (fd[FC_HAS_UV] > 0.5) & (jnp.abs(det) > 1e-12)
    inv = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    dp_du = vec.scale(vec.sub(vec.scale(e1, dv1), vec.scale(e2, dv0)), inv)
    dp_dv = vec.scale(
        vec.add(vec.scale(e1, -du1), vec.scale(e2, du0)), inv
    )
    # faces without texcoords: barycentric parameterization (uv == (b1, b2),
    # so dp_du = e1, dp_dv = e2 exactly)
    dp_du = vec.where(ok_uv, dp_du, e1)
    dp_dv = vec.where(ok_uv, dp_dv, e2)

    # neighbour-ray plane projections (shared origin o)
    dist = vec.dot(ng, p)
    safe = lambda x: jnp.where(jnp.abs(x) < 1e-12, 1e-12, x)
    t_x = (dist - vec.dot(ng, o)) / safe(vec.dot(ng, d_dx))
    t_y = (dist - vec.dot(ng, o)) / safe(vec.dot(ng, d_dy))
    dp_dx = vec.sub(vec.add(vec.scale(d_dx, t_x), o), p)
    dp_dy = vec.sub(vec.add(vec.scale(d_dy, t_y), o), p)

    a00 = vec.dot(dp_du, dp_du)
    a01 = vec.dot(dp_du, dp_dv)
    a11 = vec.dot(dp_dv, dp_dv)
    det_a = a00 * a11 - a01 * a01
    inv_det = jnp.where(
        (jnp.abs(det_a) > 1e-20) & valid, 1.0 / safe(det_a), 0.0
    )
    b0x = vec.dot(dp_du, dp_dx)
    b1x = vec.dot(dp_dv, dp_dx)
    b0y = vec.dot(dp_du, dp_dy)
    b1y = vec.dot(dp_dv, dp_dy)
    duv_dx = ((a11 * b0x - a01 * b1x) * inv_det,
              (a00 * b1x - a01 * b0x) * inv_det)
    duv_dy = ((a11 * b0y - a01 * b1y) * inv_det,
              (a00 * b1y - a01 * b0y) * inv_det)
    return duv_dx, duv_dy


def compute_interaction(scene, hit, o, d, wavelengths, ray_diff=None):
    """hit: {"t", "prim", "u", "v"} from accel.traverse; o/d vec3 tuples.

    Returns SoA dict: valid, t, p (vec3), ng (vec3), sh (frame), uv (vec2),
    wi (vec3 local), prim, bsdf (int lanes), emitter (int lanes), and
    duv_dx/duv_dy 2-tuples (zeros unless `ray_diff=(d_dx, d_dy)` camera
    differentials are given — primary rays only, like the reference's
    RayDifferential flow through bsdf.cpp:17-20).
    """
    valid = hit["prim"] >= 0
    fd = fetch_face(scene, hit["prim"])
    b1 = hit["u"]
    b2 = hit["v"]
    b0 = 1.0 - b1 - b2

    # hit position from the ray (no table needed; equivalent to the
    # barycentric formula in mesh.cpp:61 up to fp roundoff)
    p = vec.add(o, vec.scale(d, hit["t"]))
    p = vec.where(valid, p, o)
    # miss lanes fetch an all-zero row: substitute n = +z so they get a
    # safe frame
    ng = vec.where(valid, _rows3(fd, FC_NG), _unit_z(fd[0]))

    # shading normal (mesh.cpp:83-99)
    n0 = _rows3(fd, FC_N0)
    n1 = _rows3(fd, FC_N0 + 3)
    n2 = _rows3(fd, FC_N0 + 6)
    ns = vec.normalize(
        vec.add(vec.scale(n0, b0), vec.add(vec.scale(n1, b1), vec.scale(n2, b2)))
    )
    has_n = fd[FC_HAS_N] > 0.5
    n_sh = vec.where(has_n, ns, ng)

    # UVs: interpolated texcoords or barycentrics (mesh.cpp:66-73)
    has_uv = fd[FC_HAS_UV] > 0.5
    uv_u = fd[FC_UV0] * b0 + fd[FC_UV0 + 2] * b1 + fd[FC_UV0 + 4] * b2
    uv_v = fd[FC_UV0 + 1] * b0 + fd[FC_UV0 + 3] * b1 + fd[FC_UV0 + 5] * b2
    uv = (jnp.where(has_uv, uv_u, b1), jnp.where(has_uv, uv_v, b2))

    # initialize_sh_frame (interaction.h:54-60): Gram-Schmidt the precompiled
    # per-face tangent against the (possibly interpolated) shading normal
    dp_du = _rows3(fd, FC_TANGENT)
    s_raw = vec.sub(dp_du, vec.scale(n_sh, vec.dot(n_sh, dp_du)))
    degenerate = vec.norm2(s_raw) < 1e-12
    s_fallback, _ = frame.coordinate_system(n_sh)
    s = vec.normalize(vec.where(degenerate, s_fallback, s_raw))
    t = vec.cross(n_sh, s)
    sh = {"s": s, "t": t, "n": n_sh}

    wi = frame.to_local(sh, vec.neg(d))

    if ray_diff is not None:
        duv_dx, duv_dy = _uv_partials(
            fd, valid, p, o, ng, ray_diff[0], ray_diff[1]
        )
    else:
        z = jnp.zeros_like(b1)
        duv_dx = duv_dy = (z, z)

    return {
        "duv_dx": duv_dx,
        "duv_dy": duv_dy,
        "valid": valid,
        "t": jnp.where(valid, hit["t"], jnp.inf),
        "p": p,
        "ng": ng,
        "sh": sh,
        "uv": uv,
        "wi": wi,
        "prim": hit["prim"],
        "bsdf": jnp.where(valid, fd[FC_BSDF].astype(jnp.int32), 0),
        "emitter": jnp.where(valid, fd[FC_EMITTER].astype(jnp.int32) - 1, -1),
        # medium transition data (interaction.cpp:11-21): -1 = none
        "med_int": jnp.where(valid, fd[FC_MED_INT].astype(jnp.int32) - 1, -1),
        "med_ext": jnp.where(valid, fd[FC_MED_EXT].astype(jnp.int32) - 1, -1),
    }


def target_medium(si, d, current):
    """SceneInteraction::target_medium (interaction.cpp:11-13): the medium on
    the side of the surface that direction `d` points into — exterior when
    d.n > 0, interior otherwise. Lanes without a transition keep `current`."""
    transition = (si["med_int"] >= 0) | (si["med_ext"] >= 0)
    tgt = jnp.where(vec.dot(d, si["ng"]) > 0.0, si["med_ext"], si["med_int"])
    return jnp.where(si["valid"] & transition, tgt, current)


def spawn_ray_mint(p):
    """Origin offset epsilon (interaction.h spawn_ray:40-44)."""
    return (1.0 + vec.max_abs(p)) * m.RayEpsilon
