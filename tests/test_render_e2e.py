"""End-to-end render tests: physics invariants + determinism
(SURVEY.md section 4: golden-image strategy adapted — we validate against
closed-form invariants and our own deterministic streams)."""

import jax.numpy as jnp
import numpy as np
import pytest

from misaki_tpu.scene.compiler import compile_scene, load_and_compile
from misaki_tpu.scene.loader import load_string
from misaki_tpu.render.driver import render
from misaki_tpu.scene.assets import scene_path

CBOX = scene_path("cbox")


FURNACE_XML = """
<scene>
    <integrator type="path"/>
    <sensor type="perspective">
        <float name="fov" value="45"/>
        <transform name="to_world">
            <lookat origin="0, 0, -6" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="independent"><integer name="sample_count" value="16"/></sampler>
        <film type="hdrfilm">
            <integer name="width" value="32"/>
            <integer name="height" value="32"/>
        </film>
    </sensor>
    <shape type="sphere">
        <float name="radius" value="1.0"/>
        <bsdf type="diffuse">
            <spectrum name="reflectance" value="1.0"/>
        </bsdf>
    </shape>
    <emitter type="constant">
        <spectrum name="radiance" value="0.00936329"/>
    </emitter>
</scene>
"""
# 0.00936329 = 1 / 106.8 so that film Y == 1 (the reference's spectrum_to_xyz
# does not apply CIE Y normalization; integral of the y-bar table is ~106.8).


def test_furnace_white():
    """A unit-albedo diffuse sphere inside a uniform environment must vanish:
    every pixel equals the environment radiance (energy conservation of the
    whole integrator: BSDF sampling + NEE + MIS + RR)."""
    desc = load_string(FURNACE_XML)
    scene = compile_scene(desc, spp=64)
    out = render(scene, seed=0, chunk_size=1 << 16, depth_cap=8)
    rgb = np.asarray(out["rgb"])
    # Y of every pixel ~ 1.0 whether it sees the sphere or the env directly
    y = 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]
    assert abs(float(np.mean(y)) - 1.0) < 0.015, float(np.mean(y))
    assert float(np.max(np.abs(y - 1.0))) < 0.12, float(np.max(np.abs(y - 1.0)))


def test_furnace_albedo_half():
    """Albedo-0.5 sphere in a furnace: the sphere is convex, so it never sees
    itself — incident radiance is exactly the environment and the reflected
    radiance has the closed form L_out = env * albedo. Checks BSDF + NEE +
    MIS weights quantitatively, not just energy conservation."""
    desc = load_string(FURNACE_XML.replace('value="1.0"/>', 'value="0.5"/>'))
    scene = compile_scene(desc, spp=64)
    out = render(scene, seed=1, chunk_size=1 << 16, depth_cap=8)
    rgb = np.asarray(out["rgb"])
    y = 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]
    # center pixels see the sphere: expect 0.5; corners see the env: 1.0
    center = y[14:18, 14:18]
    corner = y[:4, :4]
    assert abs(float(np.mean(center)) - 0.5) < 0.02, float(np.mean(center))
    assert abs(float(np.mean(corner)) - 1.0) < 0.02, float(np.mean(corner))


@pytest.fixture(scope="module")
def cbox_small():
    return load_and_compile(CBOX, spp=16, width=64, height=48)


def test_cbox_renders_sane(cbox_small):
    out = render(cbox_small, seed=0, chunk_size=1 << 16, depth_cap=6)
    rgb = np.asarray(out["rgb"])
    assert np.isfinite(rgb).all()
    assert float(rgb.max()) > 1.0  # the light source is bright
    assert float(rgb.mean()) > 0.05  # scene is lit
    # left third redder than right third (red wall left, green wall right)
    left = rgb[:, :21]
    right = rgb[:, -21:]
    assert left[..., 0].mean() > left[..., 1].mean()
    assert right[..., 1].mean() > right[..., 0].mean()
    # alpha ~ 1 everywhere (camera inside a closed box)
    assert float(np.abs(np.asarray(out["alpha"]) - 1).max()) < 1e-3


def test_render_deterministic(cbox_small):
    a = render(cbox_small, seed=7, chunk_size=1 << 16, depth_cap=4)
    b = render(cbox_small, seed=7, chunk_size=1 << 16, depth_cap=4)
    assert np.array_equal(np.asarray(a["rgb"]), np.asarray(b["rgb"]))


def test_render_chunk_invariant(cbox_small):
    """The image must not depend on wavefront chunking (lane == pixel*spp+s
    seeding): the wavefront replacement for tile-order independence."""
    a = render(cbox_small, seed=3, chunk_size=1 << 16, depth_cap=4)
    b = render(cbox_small, seed=3, chunk_size=1 << 13, depth_cap=4)
    assert np.allclose(np.asarray(a["rgb"]), np.asarray(b["rgb"]), atol=2e-5)


def test_seed_changes_noise(cbox_small):
    a = render(cbox_small, seed=0, chunk_size=1 << 16, depth_cap=4)
    b = render(cbox_small, seed=1, chunk_size=1 << 16, depth_cap=4)
    ra, rb = np.asarray(a["rgb"]), np.asarray(b["rgb"])
    assert not np.allclose(ra, rb, atol=1e-4)  # different noise
    assert abs(ra.mean() - rb.mean()) < 0.05 * max(ra.mean(), 1e-9)  # same image


def test_spp_convergence():
    """Variance between two independent renders drops with spp."""
    s4 = load_and_compile(CBOX, spp=4, width=48, height=32)
    s32 = load_and_compile(CBOX, spp=32, width=48, height=32)
    a4 = np.asarray(render(s4, seed=0, depth_cap=4)["rgb"])
    b4 = np.asarray(render(s4, seed=9, depth_cap=4)["rgb"])
    a32 = np.asarray(render(s32, seed=0, depth_cap=4)["rgb"])
    b32 = np.asarray(render(s32, seed=9, depth_cap=4)["rgb"])
    d4 = float(np.mean((a4 - b4) ** 2))
    d32 = float(np.mean((a32 - b32) ** 2))
    assert d32 < d4 / 3.0, (d4, d32)


def test_debug_integrator_bunny_style():
    """Debug integrator renders |shading normal| (integrators/debug.cpp)."""
    desc = load_string(FURNACE_XML)
    scene = compile_scene(desc, spp=4).replace(integrator="debug")
    out = render(scene, seed=0)
    rgb = np.asarray(out["rgb"])
    assert np.isfinite(rgb).all()
    center = rgb[14:18, 14:18]
    assert center.mean() > 0.2  # sphere normals visible
