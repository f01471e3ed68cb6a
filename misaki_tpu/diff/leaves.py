"""Registry of differentiable scene-parameter leaves.

Each entry maps a stable name to (getter, replacer) over a CompiledScene.
Training code asks for a subset by name, receives the raw arrays, and gets
back a scene with those arrays swapped in — the scene compiler's packed
tables ARE the parameter store (there is no separate object graph to sync,
unlike the reference's BSDF/Texture pointers).

Leaves:
  materials   — (N_MAT_COLS, B) packed material columns: every reflectance /
                specular sigmoid coefficient, microfacet alpha slot, eta
                (column MC_ETA), conductor eta/k RGB. One matrix covers all
                BSDF + texture parameters.
  rad_coeff   — (E, 3) emitter radiance sigmoid coefficients.
  rad_curve   — (E, 95) emitter radiance curves on the CIE grid.
  env_rgb     — (He, We, 3) environment-map texels (the bilinear fetch in
                emitter/kernels.py is linear in these).
  sigma_s_amp — (M,) homogeneous-medium scattering amplitude.
  sigma_a_amp — (M,) absorption amplitude.
  medium_scale— (M,) overall sigma scale (media/homogeneous.cpp `scale`).
  bitmaps     — (3, Npad) bitmap-texture atlas texels (all mip chains; the
                bilinear/mip fetch in render/textures.py is linear in
                these). Texture optimization differentiates the base level
                THROUGH the mip chain only if the chain is rebuilt by the
                caller; at fixed mips each level gets its own gradient.
  volumes     — (1, Npad) grid-volume density table (trilinear taps in
                render/medium.py are linear in the densities).

Texel leaves are read by gathers (core/table.py fetch), whose VJP is a
scatter-add into the table."""

from dataclasses import replace as dc_replace


def _rep_materials(scene, v):
    return scene.replace(materials=type(scene.materials)(params=v))


def _rep_emitter(field):
    def rep(scene, v):
        return scene.replace(emitters=dc_replace(scene.emitters, **{field: v}))

    return rep


def _rep_bitmaps(scene, v):
    return scene.replace(bitmaps=v)


def _rep_volumes(scene, v):
    return scene.replace(volumes=v)


def _rep_media(field):
    def rep(scene, v):
        return scene.replace(media=dc_replace(scene.media, **{field: v}))

    return rep


DIFF_LEAVES = {
    "materials": (lambda s: s.materials.params, _rep_materials),
    "rad_coeff": (lambda s: s.emitters.rad_coeff, _rep_emitter("rad_coeff")),
    "rad_curve": (lambda s: s.emitters.rad_curve, _rep_emitter("rad_curve")),
    "env_rgb": (lambda s: s.emitters.env_rgb, _rep_emitter("env_rgb")),
    "sigma_s_amp": (lambda s: s.media.sigma_s_amp, _rep_media("sigma_s_amp")),
    "sigma_a_amp": (lambda s: s.media.sigma_a_amp, _rep_media("sigma_a_amp")),
    "medium_scale": (lambda s: s.media.scale, _rep_media("scale")),
    "bitmaps": (lambda s: s.bitmaps, _rep_bitmaps),
    "volumes": (lambda s: s.volumes, _rep_volumes),
}


def leaf_names():
    return tuple(DIFF_LEAVES)


def get_leaves(scene, names):
    """-> {name: array} for the requested leaf names."""
    import jax.numpy as jnp

    return {n: jnp.asarray(DIFF_LEAVES[n][0](scene)) for n in names}


def replace_leaves(scene, values):
    """Swap the given {name: array} leaves into a new CompiledScene."""
    for n, v in values.items():
        scene = DIFF_LEAVES[n][1](scene, v)
    return scene
