"""Compiled scene representation: frozen SoA device arrays + static tables.

This replaces the reference's runtime object graph (Object/Class/Properties,
include/misaki/core/{object,class,manager,properties}.h) with a
**scene compiler output** — one flat pytree of arrays consumed
by jitted wavefront kernels, plus hashable static metadata. Pointer-chasing
virtual dispatch becomes integer tables + compute-all-and-select kernels.
"""

from dataclasses import dataclass, field, fields, replace
from typing import Any

import jax
import numpy as np

# ---- integer enums (static, used inside kernels via jnp.where selects) ----

# BSDF kinds
BSDF_DIFFUSE = 0
BSDF_ROUGH_CONDUCTOR = 1
BSDF_ROUGH_DIELECTRIC = 2
BSDF_DIELECTRIC = 3       # smooth dielectric (delta lobes)
BSDF_CONDUCTOR = 4        # smooth conductor (delta reflection; stale-set parity)
BSDF_NULL = 5             # pass-through (mask/volume boundaries)
BSDF_PLASTIC = 6          # rough plastic (stale-set parity)
BSDF_DISNEY = 7           # Disney principled BRDF (stale-set parity)

# Distribution types (microfacet)
DIST_BECKMANN = 0
DIST_GGX = 1

# Texture kinds
TEX_UNIFORM = 0        # constant value inside [WAVELENGTH_MIN, MAX]
TEX_SRGB = 1           # sigmoid-coefficient reflectance spectrum
TEX_SRGB_D65 = 2       # sigmoid coeffs x D65 regular spectrum x scale
TEX_D65 = 3            # plain D65 x scale
TEX_CHECKERBOARD = 4   # two child textures selected by UV checker
TEX_BITMAP = 5         # image texture (H,W,3 sigmoid coeff planes)

# Emitter kinds
EM_AREA = 0
EM_CONSTANT = 1
EM_POINT = 2
EM_ENVMAP = 3

# Medium kinds
MED_NONE = -1
MED_HOMOGENEOUS = 0


def pytree_dataclass(cls):
    """Register a dataclass as a JAX pytree; fields named in `_static`
    are aux (hashable) data, the rest are leaves."""
    cls = dataclass(cls, frozen=True)
    static_names = tuple(getattr(cls, "_static", ()))
    data_names = tuple(
        f.name for f in fields(cls) if f.name not in static_names
    )

    def flatten(obj):
        data = tuple(getattr(obj, n) for n in data_names)
        aux = tuple(getattr(obj, n) for n in static_names)
        return data, aux

    def unflatten(aux, data):
        kwargs = dict(zip(data_names, data))
        kwargs.update(dict(zip(static_names, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


# ---- packed face-table column indices (Geometry.face_tab rows) ----
# Fetched per hit with ONE column gather (core/table.py fetch), so every
# per-face quantity lives here.
FC_NG = 0          # 0-2  geometric normal
FC_TANGENT = 3     # 3-5  raw dp_du (UV-derived or canonical ONB fallback)
FC_N0 = 6          # 6-14 vertex shading normals n0, n1, n2
FC_UV0 = 15        # 15-20 vertex texcoords uv0, uv1, uv2
FC_BSDF = 21       # material id (float-encoded int)
FC_EMITTER = 22    # emitter id + 1 (0 = none)
FC_HAS_N = 23      # 0/1
FC_HAS_UV = 24     # 0/1
FC_E1 = 25         # 25-27 edge1 (for hit-position reconstruction paths)
FC_E2 = 28         # 28-30 edge2
FC_P0 = 31         # 31-33 first vertex
FC_MED_INT = 34    # interior medium id + 1 (0 = none) — target_medium
FC_MED_EXT = 35    # exterior medium id + 1 (0 = none)   (interaction.cpp:11-21)
N_FACE_COLS = 36


# ---- packed material-table column indices (MaterialTable.params rows) ----
# One fetch per bounce; texture slots are fully baked in (no indirection):
# a "spectral slot" is 13 columns [is_checker, cA(3), cB(3), uvT(2x3)] where
# cA/cB are sigmoid-model coefficients (uniform values are encoded as
# degenerate sigmoids via table.sigmoid_inverse); a "scalar slot" is
# 9 columns [is_checker, vA, vB, uvT(2x3)].
MC_KIND = 0
MC_TWOSIDED = 1
MC_DISTR = 2
MC_ETA = 3
MC_ETA_RGB = 4     # 4-6
MC_K_RGB = 7       # 7-9
MC_REFL = 10       # 10-22 spectral slot: reflectance
MC_SPEC_REFL = 23  # 23-35 spectral slot: specular reflectance
MC_SPEC_TRANS = 36  # 36-48 spectral slot: specular transmittance
MC_ALPHA_U = 49    # 49-57 scalar slot
MC_ALPHA_V = 58    # 58-66 scalar slot
# roughplastic (bsdfs/roughplastic.cpp) extras
MC_SSW = 67        # specular sampling weight s_mean/(d_mean+s_mean)
MC_NONLINEAR = 68  # nonlinear internal-scattering compensation flag
MC_FDR = 69        # fresnel_diffuse_reflectance(eta), precomputed
# mask (bsdfs/mask.cpp): opacity-modulated nested BSDF + null lobe
MC_MASK = 70       # 0/1 — row wraps its nested BSDF in a mask
MC_OPACITY = 71    # 71-83 spectral slot: opacity
# Disney principled BRDF (bsdfs/disney_brdf.cpp) — base_color lives in the
# MC_REFL spectral slot and roughness in the MC_ALPHA_U/V scalar slots; the
# remaining nine textured parameters get scalar slots of their own
MC_DS_SUBSURFACE = 84    # 84-92 scalar slot
MC_DS_METALLIC = 93      # 93-101
MC_DS_SPECULAR = 102     # 102-110
MC_DS_SPEC_TINT = 111    # 111-119
MC_DS_ANISO = 120        # 120-128
MC_DS_SHEEN = 129        # 129-137
MC_DS_SHEEN_TINT = 138   # 138-146
MC_DS_CLEARCOAT = 147    # 147-155
MC_DS_CC_GLOSS = 156     # 156-164
N_MAT_COLS = 165

# pseudo-entry in CompiledScene.bsdf_kinds marking "some material is
# mask-wrapped" (mask is a modifier on its nested kind, not a kind itself)
MASK_FLAG = 100

SPEC_SLOT_COLS = 13
SCALAR_SLOT_COLS = 9


# ---- compact per-emitter face-pack columns (EmitterTable.face_pack) ----
# NEE area sampling needs only these per-face quantities, gathered from a
# (EF_COLS, Fmax) table with Fmax = max emissive faces (one gather returns
# the bracketing CDF values and the face data together).
EF_CDF_LO = 0      # bracketing CDF values for sample reuse
EF_CDF_HI = 1
EF_P0 = 2          # 2-4
EF_E1 = 5          # 5-7
EF_E2 = 8          # 8-10
EF_NG = 11         # 11-13
EF_N0 = 14         # 14-22 vertex shading normals
EF_HAS_N = 23
EF_COLS = 24


@pytree_dataclass
class Geometry:
    """All triangles of all shapes concatenated, world-space, component-major
    SoA (lane-last layout, see core/vec.py).

    Mirrors the reference Mesh's interleaved buffers (mesh.h:89-93) but
    decomposed into component rows, pre-transformed to world space at compile
    time (obj.cpp applies to_world at load too), and padded to a FACE_BLOCK
    multiple so the brute-force intersector streams whole face blocks.
    """

    p0: Any  # (3, Fpad) float32 — first-vertex component rows
    e1: Any  # (3, Fpad) — v1 - v0
    e2: Any  # (3, Fpad) — v2 - v0
    face_tab: Any  # (N_FACE_COLS, Fpad) float32 — packed per-face columns


@pytree_dataclass
class MaterialTable:
    """Packed per-material parameter columns (N_MAT_COLS, Bpad) — the
    differentiable material parameter store. Replaces the reference's
    BSDF + Texture object graph with one flat matrix fetched per bounce."""

    params: Any  # (N_MAT_COLS, Bpad) float32


@pytree_dataclass
class EmitterTable:
    kind: Any          # (E,) int32
    shape: Any         # (E,) int32 — owning shape for area lights (-1 else)
    # Radiance model: L(lambda) = hat_eval(rad_curve) * sigmoid(rad_coeff).
    # All reference spectra plugins collapse into this form: srgb_d65 =
    # d65-curve x sigmoid; d65/regular = curve x 1; uniform = flat curve x 1.
    rad_coeff: Any     # (E, 3) float32 — sigmoid coefficients (nm domain)
    rad_curve: Any     # (E, 95) float32 — curve on the CIE grid, pre-scaled
    position: Any      # (E, 3) float32 — point lights
    # Area sampling: per-emitter face CDFs padded to a rectangle so that
    # row slices are static under jit (ragged layouts would need dynamic
    # shapes, which XLA cannot compile).
    face_global: Any   # (E, Fmax) int32 — global face indices (padded)
    face_cdf: Any      # (E, Fmax) float32 — normalized CDF (padded with 1.0)
    face_pack: Any     # (E, EF_COLS, Fmax) float32 — compact NEE face data
    area: Any          # (E,) float32 — total surface area per emitter
    # Scene bounding sphere for infinite emitters (constant.cpp set_scene).
    bsphere_center: Any  # (3,) float32
    bsphere_radius: Any  # () float32
    # Environment map (stale-set parity: emitters/envmap.cpp — lat-long HDR
    # with 2D luminance-CDF importance sampling + sin-theta correction).
    # At most one envmap per scene; scenes without one carry (1,1) stubs.
    env_rgb: Any       # (He, We, 3) float32 — scaled linear RGB texels
    env_pmf: Any       # (He, We) float32 — discrete texel pmf (sums to 1)
    env_marg_cdf: Any  # (He,) float32 — row marginal CDF
    env_cond_cdf: Any  # (He, We) float32 — per-row conditional CDF
    env_to_world: Any  # (3, 3) float32 — rotation part of to_world
    env_to_local: Any  # (3, 3) float32 — inverse rotation


@pytree_dataclass
class MediumTable:
    """Homogeneous media parameters (media/homogeneous.cpp)."""

    kind: Any      # (M,) int32
    sigma_s: Any   # (M, 3) float32 — raw RGB (kept for reference/debug)
    sigma_a: Any   # (M, 3)
    sigma_s_coeff: Any  # (M, 3) sigmoid coeffs of sigma_s / sigma_s_amp
    sigma_a_coeff: Any  # (M, 3)
    sigma_s_amp: Any    # (M,) float32 — amplitude (sigmoid spans [0,1])
    sigma_a_amp: Any    # (M,)
    scale: Any     # (M,) float32
    g: Any         # (M,) float32 — HG phase anisotropy (0 = isotropic)
    # density-volume index into CompiledScene.volume_meta (-1 = constant
    # density 1; reference volume.h Volume::eval + volume/constant3d.cpp —
    # the constant case folds into `scale` at compile)
    density_vol: Any = field(
        default_factory=lambda: np.zeros((0,), np.int32)
    )


@pytree_dataclass
class Camera:
    to_world: Any          # (4, 4) float32
    sample_to_camera: Any  # (4, 4) float32
    near: Any              # () float32
    far: Any               # () float32


@pytree_dataclass
class BVH:
    """Flat BVH2 arrays (accel/build.py). Empty (0-node) => brute force."""

    node_lo: Any       # (N, 3) float32 AABB min
    node_hi: Any       # (N, 3) float32 AABB max
    node_left: Any     # (N,) int32 — left child, or first-prim for leaves
    node_right: Any    # (N,) int32 — right child, or prim count for leaves
    node_is_leaf: Any  # (N,) bool
    prim_order: Any    # (F,) int32 — leaf primitive permutation


@pytree_dataclass
class CompiledScene:
    geometry: Geometry
    bvh: BVH
    materials: MaterialTable
    emitters: EmitterTable
    media: MediumTable
    camera: Camera
    shape_bsdf: Any        # (S,) int32
    shape_emitter: Any     # (S,) int32 (-1 = none)
    shape_interior_medium: Any  # (S,) int32 (-1 = none)
    shape_exterior_medium: Any  # (S,) int32
    # ---- static configuration (hashable aux data) ----
    film_width: int
    film_height: int
    spp: int
    max_depth: int
    rr_depth: int
    hide_emitters: bool
    integrator: str        # "path" | "aov" | "debug" | "volpath"
    filter_type: str       # "gaussian" | "box"
    filter_stddev: float
    film_format: str       # "hdrfilm" | "rgbfilm"
    n_faces: int
    n_shapes: int
    n_emitters: int
    has_environment: bool
    environment_idx: int   # emitter index of the env light (-1 = none)
    emitter_kinds: tuple   # static per-emitter kind ints (EM_*) for unrolling
    aovs: tuple            # aov integrator channel spec
    # direct integrator sample counts (integrators/direct.cpp:21-27)
    direct_light_samples: int = 1
    direct_bsdf_samples: int = 1
    # Static set of BSDF kinds present in the scene: the compute-all-and-
    # select kernels (bsdf/kernels.py) prune absent models at trace time —
    # an all-diffuse scene (cbox) skips the GGX/fresnel machinery entirely
    # (~20% of the bounce megakernel, measured by tools/profile_stages.py).
    bsdf_kinds: tuple = (
        BSDF_DIFFUSE, BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC,
        BSDF_DIELECTRIC, BSDF_CONDUCTOR, BSDF_NULL,
    )
    # nested radiance integrator rendered by the `aov` driver (aov.cpp nests
    # an arbitrary child integrator; the loader records its kind here)
    aov_nested: str = "path"
    # film crop window offset in FULL-sensor raster pixels (film.cpp:14-21);
    # film_width/height are the CROP dimensions
    crop_x: int = 0
    crop_y: int = 0
    # differentiable-rendering mode (misaki_tpu.diff): attaches microfacet
    # alpha via the detached-sampling estimator (costlier bounce kernel);
    # training loops flip it with scene.replace(diff_mode=True)
    diff_mode: bool = False
    # bitmap texture atlas: all bitmap textures' mip chains flattened into
    # one (3, Npad) linear-RGB table (gathered per tap); meta is
    # a static tuple of per-texture (W0, H0, ((offset, W, H), ...per level)).
    bitmaps: Any = field(default_factory=lambda: np.zeros((3, 8), np.float32))
    bitmap_meta: tuple = ()
    # static set of material-slot base columns (MC_REFL / MC_SPEC_REFL /
    # MC_SPEC_TRANS / MC_ALPHA_*) that reference a bitmap texture — slots
    # not listed here skip the atlas fetch entirely at trace time
    bitmap_slots: tuple = ()
    # photon-mapping integrators (integrators/{sppm,photonmapper}.cpp):
    # photons per pass, SPPM iteration count, and the initial gather radius
    # (0 = auto: a fraction of the scene bounding-sphere radius)
    ppm_photons: int = 16384
    ppm_iterations: int = 8
    ppm_radius: float = 0.0
    # spatially-varying density volumes (reference volume.h): all grids
    # flattened into one (1, Npad) table gathered per tap;
    # volume_meta is a static tuple of (offset, W, H, D, world_to_unit
    # 12-float row-major 3x4) per volume
    volumes: Any = field(default_factory=lambda: np.zeros((1, 8), np.float32))
    volume_meta: tuple = ()

    _static = (
        "volume_meta",
        "ppm_photons",
        "ppm_iterations",
        "ppm_radius",
        "direct_light_samples",
        "direct_bsdf_samples",
        "bsdf_kinds",
        "aov_nested",
        "crop_x",
        "crop_y",
        "diff_mode",
        "bitmap_meta",
        "bitmap_slots",
        "film_width",
        "film_height",
        "spp",
        "max_depth",
        "rr_depth",
        "hide_emitters",
        "integrator",
        "filter_type",
        "filter_stddev",
        "film_format",
        "n_faces",
        "n_shapes",
        "n_emitters",
        "has_environment",
        "environment_idx",
        "emitter_kinds",
        "aovs",
    )

    def replace(self, **kw):
        return replace(self, **kw)
