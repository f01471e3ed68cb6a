"""Wavefront ray intersection — the Embree replacement
(reference scene.cpp:216-273: rtcIntersect1 / rtcOccluded1).

Lane-last SoA layout (core/vec.py): rays are component tuples of (L,) arrays.

Two on-device strategies, chosen statically per scene:

  * **block brute force** — faces are stored as component rows (3, Fpad) with
    Fpad a multiple of FACE_BLOCK; a fori_loop streams (FACE_BLOCK, L)
    elementwise Möller–Trumbore blocks with a running min-reduce carry and
    no gathers. For small scenes (cbox: 36 faces -> 1 block).

  * **BVH2 wavefront traversal** — lockstep `lax.while_loop`; each lane
    carries its own traversal stack; near-child-first ordering; leaves
    iterate up to LEAF_SIZE primitives. Node/primitive fetches are (L,)
    component gathers.

Both return SoA hits {t, prim, u, v} ((L,) each; prim = -1 on miss) and have
any-hit variants for shadow rays.
"""

import jax
import jax.numpy as jnp

from misaki_tpu.core import vec

STACK_DEPTH = 48
FACE_BLOCK = 128


def _face_block(geom, b):
    s = b * FACE_BLOCK
    p0 = tuple(jax.lax.dynamic_slice(geom.p0[k], (s,), (FACE_BLOCK,)) for k in range(3))
    e1 = tuple(jax.lax.dynamic_slice(geom.e1[k], (s,), (FACE_BLOCK,)) for k in range(3))
    e2 = tuple(jax.lax.dynamic_slice(geom.e2[k], (s,), (FACE_BLOCK,)) for k in range(3))
    return p0, e1, e2


def _mt_block_t(ox, oy, oz, dx, dy, dz, p0, e1, e2, mint, maxt):
    """Möller–Trumbore in the transposed orientation: faces on the leading
    axis, rays on the trailing one.

    Rays: (L,) components (broadcast as (1, L)); faces: (3, B) rows
    (broadcast as (B, 1)). Returns (t, u, v, hit) each (B, L).
    """
    p0x, p0y, p0z = p0[0][:, None], p0[1][:, None], p0[2][:, None]
    e1x, e1y, e1z = e1[0][:, None], e1[1][:, None], e1[2][:, None]
    e2x, e2y, e2z = e2[0][:, None], e2[1][:, None], e2[2][:, None]
    ox, oy, oz = ox[None, :], oy[None, :], oz[None, :]
    dx, dy, dz = dx[None, :], dy[None, :], dz[None, :]

    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= mint[None, :])
        & (t <= maxt[None, :])
    )
    return t, u, v, hit


def intersect_brute(geom, o, d, mint, maxt, n_faces):
    """Closest hit over all faces; o/d are vec3 tuples of (L,)."""
    Fpad = geom.p0.shape[-1]
    n_blocks = Fpad // FACE_BLOCK
    L = o[0].shape[0]
    ox, oy, oz = o
    dx, dy, dz = d

    init = (
        jnp.full((L,), jnp.inf),
        jnp.full((L,), -1, jnp.int32),
        jnp.zeros((L,)),
        jnp.zeros((L,)),
    )

    def body(b, carry):
        t_best, prim_best, u_best, v_best = carry
        p0, e1, e2 = _face_block(geom, b)
        t, u, v, hit = _mt_block_t(ox, oy, oz, dx, dy, dz, p0, e1, e2,
                                   mint, maxt)
        face_ids = b * FACE_BLOCK + jax.lax.broadcasted_iota(
            jnp.int32, (FACE_BLOCK, 1), 0
        )
        # winner select by reductions over the block: min t, then the
        # winner's attributes with a face-id tie-break (lowest t, highest id)
        t = jnp.where(hit & (face_ids < n_faces), t, jnp.inf)
        t_blk = jnp.min(t, axis=0)                        # (L,)
        sel = t <= t_blk[None, :]
        fwin = jnp.max(jnp.where(sel, face_ids, -1), axis=0)
        sel2 = sel & (face_ids == fwin[None, :])
        u_blk = jnp.max(jnp.where(sel2, u, -jnp.inf), axis=0)
        v_blk = jnp.max(jnp.where(sel2, v, -jnp.inf), axis=0)
        closer = t_blk < t_best
        t_best = jnp.where(closer, t_blk, t_best)
        prim_best = jnp.where(closer, fwin, prim_best)
        u_best = jnp.where(closer, u_blk, u_best)
        v_best = jnp.where(closer, v_blk, v_best)
        return t_best, prim_best, u_best, v_best

    if n_blocks == 1:
        t_best, prim_best, u_best, v_best = body(0, init)
    else:
        t_best, prim_best, u_best, v_best = jax.lax.fori_loop(
            0, n_blocks, body, init
        )
    return {"t": t_best, "prim": prim_best, "u": u_best, "v": v_best}


def ray_test_brute(geom, o, d, mint, maxt, n_faces):
    """Any-hit visibility test; True = occluded."""
    Fpad = geom.p0.shape[-1]
    n_blocks = Fpad // FACE_BLOCK
    L = o[0].shape[0]
    ox, oy, oz = o
    dx, dy, dz = d

    def body(b, occluded):
        p0, e1, e2 = _face_block(geom, b)
        _, _, _, hit = _mt_block_t(ox, oy, oz, dx, dy, dz, p0, e1, e2,
                                   mint, maxt)
        face_ids = b * FACE_BLOCK + jax.lax.broadcasted_iota(
            jnp.int32, (FACE_BLOCK, 1), 0
        )
        return occluded | jnp.any(hit & (face_ids < n_faces), axis=0)

    init = jnp.zeros((L,), bool)
    if n_blocks == 1:
        return body(0, init)
    return jax.lax.fori_loop(0, n_blocks, body, init)


# ---------------------------------------------------------------------------
# BVH traversal (large scenes)
# ---------------------------------------------------------------------------

def _mt_single(o, d, p0, e1, e2, mint, maxt):
    """Per-lane single-triangle Möller–Trumbore; all args vec3 tuples/(L,)."""
    pv = vec.cross(d, e2)
    det = vec.dot(e1, pv)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    tv = vec.sub(o, p0)
    u = vec.dot(tv, pv) * inv_det
    qv = vec.cross(tv, e1)
    v = vec.dot(d, qv) * inv_det
    t = vec.dot(e2, qv) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= mint)
        & (t <= maxt)
    )
    return t, u, v, hit


def _ray_aabb(o, d_rcp, lo, hi, mint, maxt):
    t0 = vec.mul(vec.sub(lo, o), d_rcp)
    t1 = vec.mul(vec.sub(hi, o), d_rcp)
    tn = (
        jnp.minimum(t0[0], t1[0]),
        jnp.minimum(t0[1], t1[1]),
        jnp.minimum(t0[2], t1[2]),
    )
    tf = (
        jnp.maximum(t0[0], t1[0]),
        jnp.maximum(t0[1], t1[1]),
        jnp.maximum(t0[2], t1[2]),
    )
    t_near = jnp.maximum(jnp.maximum(tn[0], tn[1]), jnp.maximum(tn[2], mint))
    t_far = jnp.minimum(jnp.minimum(tf[0], tf[1]), jnp.minimum(tf[2], maxt))
    return t_near <= t_far, t_near


def _bvh_loop(bvh, geom, o, d, mint, maxt, any_hit):
    # Accept host NumPy tables (direct calls outside jit).
    bvh = jax.tree_util.tree_map(jnp.asarray, bvh)
    geom = jax.tree_util.tree_map(jnp.asarray, geom)
    L = o[0].shape[0]
    d_rcp = tuple(
        1.0 / jnp.where(jnp.abs(c) < 1e-20, jnp.where(c < 0, -1e-20, 1e-20), c)
        for c in d
    )
    leaf_size = 4  # build.py LEAF_SIZE

    # node component arrays: (N,) each
    n_lo = tuple(bvh.node_lo[:, k] for k in range(3))
    n_hi = tuple(bvh.node_hi[:, k] for k in range(3))

    stack = jnp.zeros((L, STACK_DEPTH), jnp.int32)
    sp = jnp.ones((L,), jnp.int32)
    t_best = maxt
    prim_best = jnp.full((L,), -1, jnp.int32)
    u_best = jnp.zeros((L,))
    v_best = jnp.zeros((L,))
    occluded0 = jnp.zeros((L,), bool)

    def cond(carry):
        return jnp.any(carry[1] > 0)

    def body(carry):
        stack, sp, t_best, prim_best, u_best, v_best, occluded = carry
        active = sp > 0
        sp_m1 = jnp.maximum(sp - 1, 0)
        node = stack[jnp.arange(L), sp_m1]
        sp = jnp.where(active, sp_m1, sp)

        left = bvh.node_left[node]
        right = bvh.node_right[node]
        is_leaf = bvh.node_is_leaf[node]

        def leaf_step(i, inner):
            t_b, p_b, u_b, v_b, occ = inner
            in_range = i < right
            prim_slot = jnp.clip(left + i, 0, bvh.prim_order.shape[0] - 1)
            prim = bvh.prim_order[prim_slot]
            p0 = vec.gather((geom.p0[0], geom.p0[1], geom.p0[2]), prim)
            e1 = vec.gather((geom.e1[0], geom.e1[1], geom.e1[2]), prim)
            e2 = vec.gather((geom.e2[0], geom.e2[1], geom.e2[2]), prim)
            t, u, v, hit = _mt_single(o, d, p0, e1, e2, mint, t_b)
            take = active & is_leaf & in_range & hit
            occ = occ | take
            t_b = jnp.where(take, t, t_b)
            p_b = jnp.where(take, prim, p_b)
            u_b = jnp.where(take, u, u_b)
            v_b = jnp.where(take, v, v_b)
            return t_b, p_b, u_b, v_b, occ

        t_best, prim_best, u_best, v_best, occluded = jax.lax.fori_loop(
            0, leaf_size, leaf_step, (t_best, prim_best, u_best, v_best, occluded)
        )

        lo_l = vec.gather(n_lo, left)
        hi_l = vec.gather(n_hi, left)
        lo_r = vec.gather(n_lo, right)
        hi_r = vec.gather(n_hi, right)
        hit_l, tn_l = _ray_aabb(o, d_rcp, lo_l, hi_l, mint, t_best)
        hit_r, tn_r = _ray_aabb(o, d_rcp, lo_r, hi_r, mint, t_best)
        inner_active = active & ~is_leaf
        hit_l = inner_active & hit_l
        hit_r = inner_active & hit_r

        near_is_l = tn_l <= tn_r
        first = jnp.where(near_is_l, left, right)
        second = jnp.where(near_is_l, right, left)
        first_hit = jnp.where(near_is_l, hit_l, hit_r)
        second_hit = jnp.where(near_is_l, hit_r, hit_l)

        lane = jnp.arange(L)
        sp_c = jnp.clip(sp, 0, STACK_DEPTH - 1)
        stack = stack.at[lane, sp_c].set(
            jnp.where(second_hit, second, stack[lane, sp_c])
        )
        sp = jnp.where(second_hit, jnp.minimum(sp + 1, STACK_DEPTH - 1), sp)
        sp_c = jnp.clip(sp, 0, STACK_DEPTH - 1)
        stack = stack.at[lane, sp_c].set(
            jnp.where(first_hit, first, stack[lane, sp_c])
        )
        sp = jnp.where(first_hit, jnp.minimum(sp + 1, STACK_DEPTH - 1), sp)

        if any_hit:
            sp = jnp.where(occluded, 0, sp)
        return stack, sp, t_best, prim_best, u_best, v_best, occluded

    carry = (stack, sp, t_best, prim_best, u_best, v_best, occluded0)
    carry = jax.lax.while_loop(cond, body, carry)
    _, _, t_best, prim_best, u_best, v_best, occluded = carry
    return t_best, prim_best, u_best, v_best, occluded


def intersect_bvh(bvh, geom, o, d, mint, maxt):
    t, prim, u, v, _ = _bvh_loop(bvh, geom, o, d, mint, maxt, any_hit=False)
    return {"t": jnp.where(prim >= 0, t, jnp.inf), "prim": prim, "u": u, "v": v}


def ray_test_bvh(bvh, geom, o, d, mint, maxt):
    return _bvh_loop(bvh, geom, o, d, mint, maxt, any_hit=True)[4]


# ---------------------------------------------------------------------------
# Dispatch (static on scene structure)
# ---------------------------------------------------------------------------

def intersect(scene, o, d, mint, maxt):
    """Closest-hit (Scene::ray_intersect, scene.cpp:216-253). Rays are vec3
    tuples; returns {"t", "prim", "u", "v"} with t = inf on miss.

    Detached: path geometry carries no gradients (round-1 scope, SURVEY.md
    section 7 step 6; the BVH while_loop is not reverse-differentiable).
    """
    o = tuple(map(jax.lax.stop_gradient, o))
    d = tuple(map(jax.lax.stop_gradient, d))
    mint = jax.lax.stop_gradient(mint)
    maxt = jax.lax.stop_gradient(maxt)
    if scene.bvh.node_lo.shape[0] == 0:
        res = intersect_brute(scene.geometry, o, d, mint, maxt, scene.n_faces)
        res["t"] = jnp.where(res["prim"] >= 0, res["t"], jnp.inf)
    else:
        res = intersect_bvh(scene.bvh, scene.geometry, o, d, mint, maxt)
    return jax.tree_util.tree_map(jax.lax.stop_gradient, res)


def ray_test(scene, o, d, mint, maxt):
    """Shadow-ray occlusion (Scene::ray_test, scene.cpp:255-273)."""
    o = tuple(map(jax.lax.stop_gradient, o))
    d = tuple(map(jax.lax.stop_gradient, d))
    mint = jax.lax.stop_gradient(mint)
    maxt = jax.lax.stop_gradient(maxt)
    if scene.bvh.node_lo.shape[0] == 0:
        occ = ray_test_brute(scene.geometry, o, d, mint, maxt, scene.n_faces)
    else:
        occ = ray_test_bvh(scene.bvh, scene.geometry, o, d, mint, maxt)
    return jax.lax.stop_gradient(occ)
