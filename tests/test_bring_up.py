"""What the GPU bring-up rests on, checked on the CPU: the exact table
gather and its gradient, the BVH against brute force, the shipped scenes,
the image writers, the compile-cache location, the device mesh, and the
chip smoke script's entry conditions."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from misaki_tpu.accel import traverse
from misaki_tpu.core import table
from misaki_tpu.render import film as film_mod
from misaki_tpu.scene.assets import SCENES, scene_path
from misaki_tpu.scene.compiler import load_and_compile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- core/table.py fetch -------------------------------------------------

@pytest.mark.parametrize("C,N,L", [(1, 8, 5), (36, 128, 300), (3, 4097, 64)])
def test_fetch_matches_numpy_indexing(C, N, L):
    rng = np.random.default_rng(C * N + L)
    tab = rng.normal(size=(C, N)).astype(np.float32)
    idx = rng.integers(0, N, L).astype(np.int32)
    got = np.asarray(table.fetch(jnp.asarray(tab), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, tab[:, idx])


def test_fetch_out_of_range_is_zero():
    tab = np.arange(1, 13, dtype=np.float32).reshape(3, 4)
    idx = np.array([-1, 0, 3, 4, -7, 100, 2], np.int32)
    got = np.asarray(table.fetch(jnp.asarray(tab), jnp.asarray(idx)))
    want = np.zeros((3, 7), np.float32)
    ok = (idx >= 0) & (idx < 4)
    want[:, ok] = tab[:, idx[ok]]
    np.testing.assert_array_equal(got, want)


def test_fetch_lowp_returns_exact_float32_texels():
    # values a bf16 round trip would change
    tab = np.array([[1.0 + 2.0 ** -20, np.pi, 1e-30, 65504.125]], np.float32)
    idx = jnp.asarray([3, 1, 0, 2], jnp.int32)
    got = table.fetch_lowp(jnp.asarray(tab), idx)
    assert got.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(got), tab[:, [3, 1, 0, 2]])


def test_fetch_gradient_is_scatter_add():
    rng = np.random.default_rng(5)
    tab = rng.normal(size=(4, 10)).astype(np.float32)
    idx = np.array([0, 3, 3, 9, -1, 10, 3, 5], np.int32)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    g = jax.grad(lambda t: jnp.sum(table.fetch(t, jnp.asarray(idx)) * w))(
        jnp.asarray(tab))
    want = np.zeros_like(tab)
    ok = (idx >= 0) & (idx < 10)
    np.add.at(want.T, idx[ok], w[:, ok].T)
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-6, atol=1e-6)


# ---- BVH against brute force --------------------------------------------

@pytest.fixture(scope="module")
def bunny():
    return load_and_compile(scene_path("bunny"), spp=1, width=8, height=8)


def _random_rays(scene, n, seed):
    rng = np.random.default_rng(seed)
    p = np.asarray(scene.geometry.p0)[:, :scene.n_faces]
    lo, hi = p.min(axis=1), p.max(axis=1)
    o = rng.normal(size=(n, 3))
    o = 0.5 * (lo + hi) + 1.5 * np.linalg.norm(hi - lo) * o / np.linalg.norm(
        o, axis=1, keepdims=True)
    d = lo + (hi - lo) * rng.uniform(size=(n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.linalg.norm(hi - lo) * 3.0 * rng.uniform(size=n)
    return (tuple(jnp.asarray(c, jnp.float32) for c in o.T),
            tuple(jnp.asarray(c, jnp.float32) for c in d.T),
            jnp.zeros(n, jnp.float32), jnp.asarray(maxt, jnp.float32))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_bvh_matches_brute_force(bunny, kind, seed):
    assert bunny.bvh.node_lo.shape[0] > 0  # the stand-in takes the BVH path
    o, d, mint, maxt = _random_rays(bunny, 2048, seed)
    geom, F = bunny.geometry, bunny.n_faces
    if kind == "closest":
        inf = jnp.full_like(maxt, jnp.inf)
        hb = jax.tree_util.tree_map(np.asarray, traverse.intersect_bvh(
            bunny.bvh, geom, o, d, mint, inf))
        hf = jax.tree_util.tree_map(np.asarray, traverse.intersect_brute(
            geom, o, d, mint, inf, F))
        occ = np.zeros(2048, bool)
        stats = chip_smoke.compare_hits(hb, hf, occ, occ)
        assert stats["hits"] > 1000
    else:
        ob = np.asarray(traverse.ray_test_bvh(bunny.bvh, geom, o, d, mint,
                                              maxt))
        of = np.asarray(traverse.ray_test_brute(geom, o, d, mint, maxt, F))
        np.testing.assert_array_equal(ob, of)
        assert 0 < of.sum() < of.size


def test_chip_smoke_bvh_check_runs_small(bunny):
    stats = chip_smoke.bvh_vs_brute(bunny, n_rays=1024)
    assert stats["rays"] == 1024 and stats["hits"] > 0


# ---- shipped scenes ------------------------------------------------------

DECLARED = {
    "cbox": ("path", 800, 600),
    "bunny": ("debug", 768, 768),
    "teapot-full": ("volpath", 1280, 720),
    "figure2_roughconductor": ("path", 1280, 720),
    "figure3_roughdielectric": ("path", 1280, 720),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shipped_scene_loads_and_compiles(name):
    from misaki_tpu.scene.loader import load_file
    from misaki_tpu.scene.compiler import compile_scene

    desc = load_file(scene_path(name))
    integ, W, H = DECLARED[name]
    full = compile_scene(desc)
    assert full.integrator == integ
    assert (full.film_width, full.film_height) == (W, H)
    assert full.n_faces > 0 and full.n_emitters > 0


# ---- image writers -------------------------------------------------------

def test_exr_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    rgb = rng.normal(size=(5, 7, 3)).astype(np.float32) * 100
    alpha = rng.uniform(size=(5, 7)).astype(np.float32)
    film_mod.write_exr(tmp_path / "a.exr", rgb, alpha)
    got = film_mod.read_exr(tmp_path / "a.exr")
    assert sorted(got) == ["A", "B", "G", "R"]
    np.testing.assert_array_equal(
        np.stack([got["R"], got["G"], got["B"]], -1), rgb)
    np.testing.assert_array_equal(got["A"], alpha)
    film_mod.write_exr(tmp_path / "y.exr", alpha)
    np.testing.assert_array_equal(film_mod.read_exr(tmp_path / "y.exr")["Y"],
                                  alpha)


def test_png_round_trip(tmp_path):
    import struct
    import zlib

    rng = np.random.default_rng(3)
    rgb = rng.uniform(size=(6, 9, 3)).astype(np.float32)
    film_mod.write_png(tmp_path / "a.png", rgb)
    data = (tmp_path / "a.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    W, H = struct.unpack(">II", data[16:24])
    assert (W, H) == (9, 6)
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == \
            zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + 3 * W)
    assert not raw[:, 0].any()  # filter type 0 on every scanline
    np.testing.assert_array_equal(raw[:, 1:].reshape(H, W, 3),
                                  film_mod.to_srgb8(rgb))


# ---- compile cache -------------------------------------------------------

def test_compile_cache_respects_environment(monkeypatch, tmp_path):
    from misaki_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from misaki_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.setup_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


# ---- device mesh ---------------------------------------------------------

def test_make_mesh_raises_with_too_few_devices():
    from misaki_tpu.parallel.sharding import make_mesh

    n = len(jax.devices())
    assert make_mesh(n).devices.size == n
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n + 1)


# ---- chip_smoke.py -------------------------------------------------------

def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    res = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert res.returncode != 0
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] is False


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.parametrize("argv,want", [([], "one_card"),
                                       (["--four-cards"], "four_cards")])
def test_chip_smoke_option_selects_phases(monkeypatch, capsys, argv, want):
    calls = []
    devs = jax.devices()
    monkeypatch.setattr(chip_smoke, "device_phase", lambda: devs)
    monkeypatch.setattr(chip_smoke, "one_card",
                        lambda: calls.append("one_card"))
    monkeypatch.setattr(chip_smoke, "four_cards",
                        lambda: calls.append("four_cards") or devs[:4])
    assert chip_smoke.main(argv) == 0
    assert calls == [want]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["count"] == (4 if want == "four_cards" else 1)


# ---- on the card (skips here) -------------------------------------------

@pytest.mark.gpu
def test_gpu_gather_and_develop_are_exact(gpu_device):
    """No TF32 on the card: the face gather and the film develop matmul
    return float32 results."""
    from misaki_tpu.core.spectrum import xyz_to_srgb_image

    rng = np.random.default_rng(0)
    tab = rng.normal(size=(36, 4096)).astype(np.float32)
    idx = rng.integers(-1, 4096, 1 << 16).astype(np.int32)
    with jax.default_device(gpu_device):
        got = np.asarray(table.fetch(jnp.asarray(tab), jnp.asarray(idx)))
        img = rng.uniform(size=(64, 64, 3)).astype(np.float32) + 1.0 / 3.0
        dev = np.asarray(jax.jit(xyz_to_srgb_image)(jnp.asarray(img)))
    want = np.where(idx >= 0, tab[:, np.maximum(idx, 0)], 0.0)
    np.testing.assert_array_equal(got, want)
    cpu = np.asarray(xyz_to_srgb_image(jax.device_put(
        jnp.asarray(img), jax.devices("cpu")[0])))
    np.testing.assert_allclose(dev, cpu, rtol=1e-6, atol=1e-6)


# ---- film splat ----------------------------------------------------------

def test_partial_last_chunk_matches_single_chunk():
    """A chunk size that does not divide the frame: the last chunk reaches
    past the film's end and must still splat at its own pixels."""
    from misaki_tpu.render.driver import render

    scene = load_and_compile(scene_path("cbox"), spp=4, width=20, height=15)
    one = render(scene, seed=2, chunk_size=1 << 12, depth_cap=2)
    parts = render(scene, seed=2, chunk_size=4 * 128, depth_cap=2)  # 2.3
    np.testing.assert_allclose(np.asarray(parts["alpha"]), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(parts["rgb"]),
                               np.asarray(one["rgb"]), rtol=1e-4, atol=1e-5)
