"""Texture-slot evaluation on packed material columns
(reference: src/librender/spectra/{uniform,srgb}.cpp,
textures/{checkerboard,bitmap}.cpp; see scene/types.py slot layout).

Every BSDF texture is baked into its material's packed columns at scene
compile: a spectral slot holds two sigmoid-coefficient triples (A and the
checkerboard's second color B) plus a 2x3 UV transform; `uniform` values are
encoded as degenerate sigmoids (exactly representable). Evaluation is pure
closed-form math with no table indirection, except bitmap slots
(slot[0] == 2), which bilinearly fetch the scene's mip-chained texel atlas
with four exact gathers (core/table.py fetch_lowp); the mip level
comes from the primary-ray UV footprint (screen-space ray differentials,
interaction.py _uv_partials) — an anti-aliasing upgrade over the
reference's unfiltered bilinear (textures/bitmap.cpp:31-38).
"""

import jax.numpy as jnp

from misaki_tpu.core.table import fetch_lowp

# spectral-slot mode values (slot[0])
SLOT_PLAIN = 0.0
SLOT_CHECKER = 1.0
SLOT_BITMAP = 2.0


def _sigmoid_spectrum(c0, c1, c2, wavelengths):
    """srgb.h:8-19 sigmoid model; c* are (L,), wavelengths (4, L)."""
    v = (c0[None, :] * wavelengths + c1[None, :]) * wavelengths + c2[None, :]
    return jnp.maximum(0.5 * v / jnp.sqrt(v * v + 1.0) + 0.5, 0.0)


def _slot_uv(slot, uv):
    """Apply the slot's baked 2x3 to_uv transform."""
    uu, vv = uv
    u = slot[-6] * uu + slot[-5] * vv + slot[-4]
    v = slot[-3] * uu + slot[-2] * vv + slot[-1]
    return u, v


def _checker_pick(slot, uv):
    """checkerboard.cpp: to_uv transform, (u>.5 == v>.5) picks color0/A."""
    u, v = _slot_uv(slot, uv)
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)
    return (u > 0.5) == (v > 0.5)


def bitmap_fetch_rgb(scene, tex_id, u, v, duv=None):
    """Bilinear texel fetch of bitmap `tex_id` at (u, v) (wrapped, like the
    reference's uv - floor(uv), bitmap.cpp:31-32), from the mip level chosen
    by the screen-space footprint. The (static) level unroll only computes
    ABSOLUTE tap indices + weights; the texels are then fetched with four
    gathers. Returns (r, g, b) tuples of (L,)."""
    W0, H0, levels = scene.bitmap_meta[tex_id]
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)

    if duv is None:
        lvl = jnp.zeros_like(u)
    else:
        (dudx, dvdx), (dudy, dvdy) = duv
        # footprint in base-level texels; level = log2 (clamped)
        fp = jnp.maximum(
            jnp.maximum(jnp.abs(dudx), jnp.abs(dudy)) * W0,
            jnp.maximum(jnp.abs(dvdx), jnp.abs(dvdy)) * H0,
        )
        lvl = jnp.floor(jnp.log2(jnp.maximum(fp, 1.0)))
        lvl = jnp.clip(lvl, 0.0, len(levels) - 1.0)

    L = u.shape[0]
    idx = [jnp.zeros(L, jnp.int32)] * 4
    wgt = [jnp.zeros(L)] * 4
    for li, (off, W, H) in enumerate(levels):
        sel = lvl == li if li < len(levels) - 1 else lvl >= li
        fu = u * W - 0.5
        fv = v * H - 0.5
        j0 = jnp.floor(fu)
        i0 = jnp.floor(fv)
        tu = fu - j0
        tv = fv - i0
        j0i = jnp.mod(j0.astype(jnp.int32), W)
        j1i = jnp.mod(j0.astype(jnp.int32) + 1, W)
        # wrap v like u (reference wraps both axes via uv - floor(uv),
        # bitmap.cpp:31-32); clamping v left a one-texel seam on tiles
        i0i = jnp.mod(i0.astype(jnp.int32), H)
        i1i = jnp.mod(i0.astype(jnp.int32) + 1, H)
        for k, (ii, jj, w) in enumerate((
            (i0i, j0i, (1.0 - tu) * (1.0 - tv)),
            (i0i, j1i, tu * (1.0 - tv)),
            (i1i, j0i, (1.0 - tu) * tv),
            (i1i, j1i, tu * tv),
        )):
            idx[k] = jnp.where(sel, off + ii * W + jj, idx[k])
            wgt[k] = jnp.where(sel, w, wgt[k])

    atlas = scene.bitmaps  # (3, Npad)
    out = sum(fetch_lowp(atlas, idx[k]) * wgt[k][None, :] for k in range(4))
    return (out[0], out[1], out[2])


def eval_spectral_slot(slot, uv, wavelengths, scene=None, duv=None):
    """slot: (13, L) rows [mode, cA(3), cB(3), uvT(6)] -> (4, L).

    mode 0: plain sigmoid-spectrum A; mode 1: checkerboard A/B; mode 2:
    bitmap — cA[0] holds the static texture id, texels are lifted to hero
    wavelengths with the channel-anchor model (rgb_to_spectral, the
    documented spectral semantics for RGB-valued data)."""
    is_checker = jnp.abs(slot[0] - SLOT_CHECKER) < 0.25
    pick_a = jnp.where(is_checker, _checker_pick(slot, uv), True)
    c0 = jnp.where(pick_a, slot[1], slot[4])
    c1 = jnp.where(pick_a, slot[2], slot[5])
    c2 = jnp.where(pick_a, slot[3], slot[6])
    out = _sigmoid_spectrum(c0, c1, c2, wavelengths)

    if scene is not None and len(getattr(scene, "bitmap_meta", ())) > 0:
        from misaki_tpu.bsdf.kernels import rgb_to_spectral

        is_bitmap = jnp.abs(slot[0] - SLOT_BITMAP) < 0.25
        u, v = _slot_uv(slot, uv)
        for tid in range(len(scene.bitmap_meta)):
            mask = is_bitmap & (jnp.abs(slot[1] - tid) < 0.25)
            rgb = bitmap_fetch_rgb(scene, tid, u, v, duv)
            spec = jnp.maximum(rgb_to_spectral(rgb, wavelengths), 0.0)
            out = jnp.where(mask[None, :], spec, out)
    return out


def eval_scalar_slot(slot, uv, scene=None, duv=None):
    """slot: (9, L) rows [mode, vA, vB, uvT(6)] -> (L,). Bitmap mode uses
    the texel luminance (bitmap.cpp eval_1)."""
    is_checker = jnp.abs(slot[0] - SLOT_CHECKER) < 0.25
    pick_a = jnp.where(is_checker, _checker_pick(slot, uv), True)
    out = jnp.where(pick_a, slot[1], slot[2])
    if scene is not None and len(getattr(scene, "bitmap_meta", ())) > 0:
        is_bitmap = jnp.abs(slot[0] - SLOT_BITMAP) < 0.25
        u, v = _slot_uv(slot, uv)
        for tid in range(len(scene.bitmap_meta)):
            mask = is_bitmap & (jnp.abs(slot[1] - tid) < 0.25)
            r, g, b = bitmap_fetch_rgb(scene, tid, u, v, duv)
            lum = r * 0.212671 + g * 0.715160 + b * 0.072169
            out = jnp.where(mask, lum, out)
    return out
