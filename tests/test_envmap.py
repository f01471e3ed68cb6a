"""Environment-map emitter tests (stale-set parity: emitters/envmap.cpp —
lat-long HDR with 2D luminance-CDF importance sampling + sin-theta
correction; see SURVEY.md section 2.4).

Covers: RGBE .hdr decoding, direction<->uv mapping, pdf normalization over
the sphere, sample/pdf consistency, importance-sampled quadrature against a
direct texel-grid integral, and an end-to-end render.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from misaki_tpu.scene.compiler import load_and_compile
from misaki_tpu.scene.types import EM_ENVMAP
from misaki_tpu.emitter import kernels as ek


def _write_flat_hdr(path, rgb):
    """Flat (non-RLE) Radiance RGBE writer, little-known enough that the
    reader must handle it: mantissa = c / 2^(e-128) with shared exponent."""
    H, W, _ = rgb.shape
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {H} +X {W}\n".encode()
    m = rgb.max(axis=-1)
    exp = np.where(m > 1e-32, np.floor(np.log2(np.maximum(m, 1e-32))) + 1, 0)
    scale = np.where(m > 1e-32, 2.0 ** (8.0 - exp), 0.0)
    mant = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    e8 = np.where(m > 1e-32, exp + 128, 0).astype(np.uint8)
    rgbe = np.concatenate([mant, e8[..., None]], axis=-1)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rgbe.tobytes())


def _quad_obj(path):
    path.write_text(
        "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
        "f 1 2 3\nf 1 3 4\n"
    )


SCENE_XML = """<scene version="0.6.0">
  <integrator type="path"><integer name="max_depth" value="{depth}"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="60"/>
    <transform name="to_world">
      <lookat origin="0, 1, 4" target="0, 0.5, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sample_count" value="4"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="16"/>
      <integer name="height" value="12"/>
      <rfilter type="gaussian"/>
    </film>
  </sensor>
  <emitter type="envmap">
    <string name="filename" value="{hdr}"/>
    <float name="scale" value="{scale}"/>
  </emitter>
  <shape type="obj">
    <string name="filename" value="{obj}"/>
    <bsdf type="diffuse"/>
  </shape>
</scene>
"""


@pytest.fixture(scope="module")
def env_scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("envmap")
    H, W = 16, 32
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0.05, 0.3, (H, W, 3)).astype(np.float32)
    rgb[3:6, 10:16] = [8.0, 6.0, 2.0]  # bright patch to drive importance
    _write_flat_hdr(tmp / "env.hdr", rgb)
    _quad_obj(tmp / "quad.obj")
    xml = SCENE_XML.format(depth=3, hdr="env.hdr", scale=1.5, obj="quad.obj")
    (tmp / "scene.xml").write_text(xml)
    scene = load_and_compile(str(tmp / "scene.xml"))
    return scene, rgb


def test_hdr_roundtrip(tmp_path):
    from misaki_tpu.scene.compiler import _read_rgbe_hdr

    rgb = np.abs(np.random.default_rng(1).normal(1.0, 2.0, (7, 9, 3))).astype(
        np.float32
    )
    _write_flat_hdr(tmp_path / "t.hdr", rgb)
    back = _read_rgbe_hdr(tmp_path / "t.hdr")
    assert back.shape == (7, 9, 3)
    # RGBE quantization is ~1/256 of the per-pixel MAX channel (shared
    # exponent), so small channels next to big ones see larger relative error
    step = rgb.max(axis=-1, keepdims=True) / 64.0
    assert (np.abs(back - rgb) <= step + 1e-3).all()


def test_envmap_compiles(env_scene):
    scene, rgb = env_scene
    assert scene.has_environment
    assert scene.emitter_kinds[scene.environment_idx] == EM_ENVMAP
    em = scene.emitters
    assert em.env_rgb.shape == (16, 32, 3)
    np.testing.assert_allclose(np.asarray(em.env_marg_cdf)[-1], 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(em.env_cond_cdf)[:, -1], 1.0, rtol=1e-6)
    # scale baked into texels (tolerance = RGBE shared-exponent quantization)
    want = rgb * 1.5
    step = want.max(axis=-1, keepdims=True) / 64.0
    assert (np.abs(np.asarray(em.env_rgb) - want) <= step + 1e-3).all()


def test_uv_dir_roundtrip(env_scene):
    scene, _ = env_scene
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.uniform(0.01, 0.99, 256).astype(np.float32))
    v = jnp.asarray(rng.uniform(0.01, 0.99, 256).astype(np.float32))
    d, _ = ek._env_uv_to_dir(scene, u, v)
    u2, v2, _ = ek._env_dir_to_uv(scene, d)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u), atol=1e-5)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v), atol=1e-5)


def test_env_absolute_orientation(env_scene):
    """Absolute orientation lock against the reference convention
    (envmap.cpp:43-47 / 65-67): a direction built as
    d = (sin(u*2pi) sin(v*pi), cos(v*pi), -cos(u*2pi) sin(v*pi)) must look up
    the texel at (u, v) — no 180-degree yaw offset. The bright patch in the
    fixture sits at rows 3:6, cols 10:16 of the 16x32 map."""
    scene, rgb_tex = env_scene
    He, We = rgb_tex.shape[:2]
    # center of the bright patch
    i, j = 4, 12
    u = (j + 0.5) / We
    v = (i + 0.5) / He
    theta, phi = v * np.pi, u * 2.0 * np.pi
    d_ref = (
        jnp.asarray([np.sin(phi) * np.sin(theta)], np.float32),
        jnp.asarray([np.cos(theta)], np.float32),
        jnp.asarray([-np.cos(phi) * np.sin(theta)], np.float32),
    )
    wav = jnp.full((4, 1), 550.0)
    bright = float(ek._env_radiance_spec(scene, d_ref, wav).mean())
    # the yaw-opposite direction must land in the dim background
    d_opp = (-d_ref[0], d_ref[1], -d_ref[2])
    dim = float(ek._env_radiance_spec(scene, d_opp, wav).mean())
    assert bright > 5.0, bright     # patch radiance ~ 8 x 1.5 scale
    assert dim < 1.0, dim
    # and the uv mapping itself must invert to (u, v) exactly
    u2, v2, _ = ek._env_dir_to_uv(scene, d_ref)
    np.testing.assert_allclose(float(u2[0]), u, atol=1e-5)
    np.testing.assert_allclose(float(v2[0]), v, atol=1e-5)


def test_env_pdf_normalizes(env_scene):
    """MC over the uniform sphere: E[pdf_env / p_uniform] must be 1."""
    from misaki_tpu.core import warp

    scene, _ = env_scene
    rng = np.random.default_rng(3)
    n = 200_000
    u2 = (
        jnp.asarray(rng.uniform(size=n).astype(np.float32)),
        jnp.asarray(rng.uniform(size=n).astype(np.float32)),
    )
    d = warp.square_to_uniform_sphere(u2)
    u, v, sin_t = ek._env_dir_to_uv(scene, d)
    pdf = np.asarray(ek._env_pdf_sa(scene, u, v, sin_t))
    est = pdf.mean() * 4.0 * np.pi
    assert abs(est - 1.0) < 0.02, est


def test_env_sample_pdf_consistency(env_scene):
    """pdf returned by the sampler == pdf_emitter_direct of the sampled
    direction (both nearest-texel; must agree away from texel edges)."""
    scene, _ = env_scene
    rng = np.random.default_rng(4)
    n = 4096
    u2 = (
        jnp.asarray(rng.uniform(size=n).astype(np.float32)),
        jnp.asarray(rng.uniform(size=n).astype(np.float32)),
    )
    ref_p = tuple(jnp.zeros(n) for _ in range(3))
    wav = jnp.full((4, n), 550.0)
    s = ek._sample_envmap_emitter(scene, scene.environment_idx, ref_p, wav, u2)
    ids = jnp.full((n,), scene.environment_idx, jnp.int32)
    pdf2 = np.asarray(
        ek.pdf_emitter_direct(scene, ids, s["d"], s["dist"], s["d"])
    )
    pdf1 = np.asarray(s["pdf"])
    ok = np.isclose(pdf1, pdf2, rtol=1e-3)
    assert ok.mean() > 0.99, f"{(~ok).sum()} of {n} disagree"


def test_env_importance_quadrature(env_scene):
    """E[lum(d)/pdf(d)] over importance samples == the texel-grid integral
    of luminance over the sphere (low variance because pdf tracks lum)."""
    scene, _ = env_scene
    em = scene.emitters
    rgb = np.asarray(em.env_rgb)
    He, We = rgb.shape[:2]
    lum_w = np.array([0.212671, 0.715160, 0.072169])
    lum = rgb @ lum_w
    theta = (np.arange(He) + 0.5) / He * np.pi
    texel_sa = (np.pi / He) * (2 * np.pi / We) * np.sin(theta)[:, None]
    integral = float((lum * texel_sa).sum())

    rng = np.random.default_rng(5)
    n = 100_000
    u2 = (
        jnp.asarray(rng.uniform(size=n).astype(np.float32)),
        jnp.asarray(rng.uniform(size=n).astype(np.float32)),
    )
    ref_p = tuple(jnp.zeros(n) for _ in range(3))
    wav = jnp.full((4, n), 550.0)
    s = ek._sample_envmap_emitter(scene, scene.environment_idx, ref_p, wav, u2)
    rgb_s = np.stack(
        [np.asarray(c) for c in ek._env_bilinear_rgb(
            scene, *ek._env_dir_to_uv(scene, s["d"])[:2]
        )],
        axis=-1,
    )
    pdf = np.asarray(s["pdf"])
    f = rgb_s @ lum_w
    est = float(np.mean(np.where(pdf > 0, f / np.maximum(pdf, 1e-20), 0.0)))
    assert abs(est - integral) < 0.03 * integral, (est, integral)


def test_envmap_render_e2e(env_scene):
    from misaki_tpu.render.driver import render

    scene, rgb_tex = env_scene
    out = render(scene, seed=0, depth_cap=2)
    img = np.asarray(out["rgb"])
    assert np.isfinite(img).all()
    assert img.mean() > 0.01  # env is visible + lights the quad


def test_envmap_1024x2048_full_res(tmp_path):
    """A 1024x2048 HDR must compile WITHOUT downsampling (ENV_MAX_RES) and
    the bilinear fetch must return the exact texel values."""
    H, W = 1024, 2048
    iy, ix = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rgb = np.stack([
        0.1 + 0.9 * (ix % 97) / 97.0,
        0.1 + 0.9 * (iy % 53) / 53.0,
        np.full((H, W), 0.25),
    ], axis=-1).astype(np.float32)
    _write_flat_hdr(tmp_path / "big.hdr", rgb)
    _quad_obj(tmp_path / "quad.obj")
    xml = SCENE_XML.format(depth=2, hdr="big.hdr", scale=1.0, obj="quad.obj")
    (tmp_path / "scene.xml").write_text(xml)
    scene = load_and_compile(str(tmp_path / "scene.xml"))
    env = np.asarray(scene.emitters.env_rgb)
    assert env.shape == (1024, 2048, 3)  # full res retained
    # texel-center fetch returns the exact stored texels
    L = 64
    rng = np.random.default_rng(2)
    ii = rng.integers(0, H, L)
    jj = rng.integers(0, W, L)
    u = jnp.asarray((jj + 0.5) / W, jnp.float32)
    v = jnp.asarray((ii + 0.5) / H, jnp.float32)
    r, g, b = ek._env_bilinear_rgb(scene, u, v)
    got = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], -1)
    np.testing.assert_allclose(got, env[ii, jj], rtol=1e-3, atol=1e-3)


def test_native_radiance_decoupled_from_sampler(tmp_path, monkeypatch):
    """The RADIANCE texels keep native resolution while the
    importance-sampling tables are built from a
    downsampled copy. The pdf describes the sampler's own distribution, so
    the estimator stays unbiased: renders with coarse vs full-res sampler
    tables must converge to the same image (radiance is identical)."""
    H, W = 32, 64
    rng = np.random.default_rng(7)
    rgb = rng.uniform(0.05, 0.4, (H, W, 3)).astype(np.float32)
    rgb[10:14, 20:30] = [6.0, 5.0, 2.0]
    _write_flat_hdr(tmp_path / "env.hdr", rgb)
    _quad_obj(tmp_path / "quad.obj")
    xml = SCENE_XML.format(depth=2, hdr="env.hdr", scale=1.0, obj="quad.obj")
    (tmp_path / "scene.xml").write_text(xml)

    monkeypatch.setenv("MISAKI_ENV_MAX_RES", "8,16")
    coarse = load_and_compile(str(tmp_path / "scene.xml"), spp=64)
    assert np.asarray(coarse.emitters.env_rgb).shape == (32, 64, 3)
    assert np.asarray(coarse.emitters.env_pmf).shape == (8, 16)

    monkeypatch.setenv("MISAKI_ENV_MAX_RES", "64,64")
    full = load_and_compile(str(tmp_path / "scene.xml"), spp=64)
    assert np.asarray(full.emitters.env_pmf).shape == (32, 64)

    from misaki_tpu.render.driver import render

    img_c = np.asarray(render(coarse, seed=3, depth_cap=2)["rgb"])
    img_f = np.asarray(render(full, seed=4, depth_cap=2)["rgb"])
    assert np.isfinite(img_c).all()
    # same target image, different sampler variance: compare means
    rel = abs(img_c.mean() - img_f.mean()) / img_f.mean()
    assert rel < 0.08, (img_c.mean(), img_f.mean())


def test_envmap_bilinear_matches_numpy(tmp_path):
    """The env fetch is a bilinear tap at texel centers — u wraps, v clamps
    — read exactly from the float32 texels."""
    H, W = 64, 128
    rng = np.random.default_rng(3)
    rgb = rng.uniform(0.0, 4.0, (H, W, 3)).astype(np.float32)
    _write_flat_hdr(tmp_path / "env.hdr", rgb)
    _quad_obj(tmp_path / "quad.obj")
    xml = SCENE_XML.format(depth=2, hdr="env.hdr", scale=1.0, obj="quad.obj")
    (tmp_path / "scene.xml").write_text(xml)
    scene = load_and_compile(str(tmp_path / "scene.xml"))
    env = np.asarray(scene.emitters.env_rgb)
    L = 300
    u = rng.uniform(size=L).astype(np.float32)
    v = rng.uniform(size=L).astype(np.float32)
    got = np.stack([np.asarray(c) for c in ek._env_bilinear_rgb(
        scene, jnp.asarray(u), jnp.asarray(v))], -1)

    fu, fv = u * W - 0.5, v * H - 0.5
    j0, i0 = np.floor(fu).astype(int), np.floor(fv).astype(int)
    tu, tv = (fu - j0)[:, None], (fv - i0)[:, None]
    j1, j0 = (j0 + 1) % W, j0 % W
    i1, i0 = np.clip(i0 + 1, 0, H - 1), np.clip(i0, 0, H - 1)
    want = ((1 - tu) * (1 - tv) * env[i0, j0] + tu * (1 - tv) * env[i0, j1]
            + (1 - tu) * tv * env[i1, j0] + tu * tv * env[i1, j1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
