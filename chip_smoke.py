#!/usr/bin/env python
"""On-card smoke test: drive the renderer's normal entry points once on a
GPU at the sizes users render at, and check what comes out.

    python chip_smoke.py               # one card: the phases below
    python chip_smoke.py --four-cards  # only the sharded path on 4 cards

Phases (one card):
  1. device      — JAX must see a GPU; prints nvidia-smi's name and power
                   limit and the device kind.
  2. cbox        — the CLI renders the scene's 800x600 at 64 spp, path
                   integrator, depth cap 4 (30 chunks of 2^20 lanes; brute-
                   force intersector), to a PNG and an EXR; the EXR is
                   checked (finite, red wall left, green right, alpha 1).
  3. bunny       — debug integrator at 768x768, 1 spp, and the path
                   integrator at 256x256, 16 spp, depth cap 4 (BVH closest-
                   and any-hit casts); then the BVH intersectors against the
                   brute-force ones for 2^18 random rays.
  4. figure2     — rough conductor + checkerboard + constant env at 320x180,
                   16 spp, depth cap 4.
  5. train step  — train_step_sharded on a one-card mesh: cbox 256x256,
                   16 spp, depth cap 3, diff_mode, default leaves.
  6. parity      — tools/check_gpu_cpu_parity.py: cbox and bunny renders and
                   the one-card gradient against a CPU subprocess.

For each phase a JSON line gives its compile seconds (an ahead-of-time
compile of its main jitted program), run seconds (a second, warm call) and
that program's compiled.memory_analysis(). Any failure ends the run with a
non-zero exit code. The last line is
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(json.dumps({"ok": False, "error": msg}))
    sys.exit(1)


def log(**kw):
    print(json.dumps(kw), flush=True)


def memory(compiled):
    """The *_in_bytes fields of compiled.memory_analysis()."""
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {k: int(getattr(ma, k)) for k in dir(ma) if k.endswith("_in_bytes")}


def aot(jitted, *args, **kw):
    """Compile `jitted` for these arguments ahead of time; -> (seconds,
    memory analysis). The executable lands in the persistent compile cache,
    so the entry point's own call that follows loads it."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kw).compile()
    return time.perf_counter() - t0, memory(compiled)


def timed(fn):
    """Seconds of fn() (which returns a device array), synced."""
    t0 = time.perf_counter()
    out = fn()
    out.block_until_ready()
    return time.perf_counter() - t0, out


def device_phase():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"no GPU: JAX runs on {devices[0].platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi)  # one "name, power limit" line per card
    log(phase="device", device_kind=devices[0].device_kind,
        count=len(devices))
    return devices


def check_cbox_image(rgb, alpha):
    import numpy as np

    if not np.isfinite(rgb).all():
        raise AssertionError("cbox: non-finite pixels")
    third = rgb.shape[1] // 3
    left, right = rgb[:, :third], rgb[:, -third:]
    if not left[..., 0].mean() > left[..., 1].mean():
        raise AssertionError("cbox: left wall is not red")
    if not right[..., 1].mean() > right[..., 0].mean():
        raise AssertionError("cbox: right wall is not green")
    if float(np.abs(alpha - 1.0).max()) > 1e-3:
        raise AssertionError("cbox: alpha is not 1")


def cbox_phase(out_dir):
    import jax.numpy as jnp
    import numpy as np

    from misaki_tpu import cli
    from misaki_tpu.render import driver, film as film_mod
    from misaki_tpu.scene.assets import scene_path
    from misaki_tpu.scene.compiler import load_and_compile

    path = scene_path("cbox")
    scene = load_and_compile(path, spp=64)
    W, H, spp = scene.film_width, scene.film_height, scene.spp
    n_total = W * H * spp
    chunk = driver.pick_chunk(driver.DEFAULT_CHUNK, spp, n_total)
    film_flat = film_mod.new_film_flat(H, W, 5, scene.filter_type,
                                       scene.filter_stddev)
    compile_s, mem = aot(driver.render_chunk, scene, film_flat,
                         jnp.uint32(0), n_total, jnp.uint32(0), chunk, 4)
    argv = [path, "--spp", "64", "--depth", "4"]
    png = os.path.join(out_dir, "cbox.png")
    exr = os.path.join(out_dir, "cbox.exr")
    t0 = time.perf_counter()
    if cli.main(argv + ["-o", png]) != 0:
        raise AssertionError("cli failed")
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if cli.main(argv + ["-o", exr]) != 0:
        raise AssertionError("cli failed")
    run_s = time.perf_counter() - t0
    img = film_mod.read_exr(exr)
    rgb = np.stack([img["R"], img["G"], img["B"]], -1)
    check_cbox_image(rgb, img["A"])
    log(phase="cbox", size=[W, H], spp=spp, chunks=-(-n_total // chunk),
        compile_s=compile_s, first_cli_s=first_s, run_cli_s=run_s,
        samples_per_s=n_total / run_s, memory=mem,
        mean_rgb=rgb.mean(axis=(0, 1)).tolist())


def render_phase(name, scene, depth_cap, **extra):
    """AOT-compile the scene's single-chunk frame program, then render it
    twice through driver.render (warm, then timed)."""
    import jax.numpy as jnp
    import numpy as np

    from misaki_tpu.render import driver

    n_total = scene.film_width * scene.film_height * scene.spp
    chunk = driver.pick_chunk(driver.DEFAULT_CHUNK, scene.spp, n_total)
    if chunk < n_total:
        raise AssertionError(f"{name}: expected a single-chunk frame")
    compile_s, mem = aot(driver.render_frame_single, scene, n_total,
                         jnp.uint32(0), chunk, depth_cap)
    first_s, _ = timed(lambda: driver.render(scene, seed=0,
                                             depth_cap=depth_cap)["rgb"])
    run_s, rgb = timed(lambda: driver.render(scene, seed=1,
                                             depth_cap=depth_cap)["rgb"])
    rgb = np.asarray(rgb)
    if not np.isfinite(rgb).all() or not rgb.mean() > 0.0:
        raise AssertionError(f"{name}: image is not finite and lit")
    log(phase=name, size=[scene.film_width, scene.film_height],
        spp=scene.spp, depth_cap=depth_cap, compile_s=compile_s,
        first_s=first_s, run_s=run_s, samples_per_s=n_total / run_s,
        memory=mem, mean_rgb=rgb.mean(axis=(0, 1)).tolist(), **extra)
    return rgb


def bvh_vs_brute(scene, n_rays=1 << 18, seed=0):
    """Closest- and any-hit: BVH against brute force on random rays aimed
    into the scene's bounding box. -> stats; raises on disagreement."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from misaki_tpu.accel import traverse

    rng = np.random.default_rng(seed)
    F = scene.n_faces
    p = np.asarray(scene.geometry.p0)[:, :F]
    lo, hi = p.min(axis=1), p.max(axis=1)
    center, ext = 0.5 * (lo + hi), hi - lo
    o = rng.normal(size=(n_rays, 3))
    o = center + 1.5 * np.linalg.norm(ext) * o / np.linalg.norm(
        o, axis=1, keepdims=True)
    target = lo + ext * rng.uniform(size=(n_rays, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = tuple(jnp.asarray(c, jnp.float32) for c in o.T)
    d = tuple(jnp.asarray(c, jnp.float32) for c in d.T)
    mint = jnp.zeros(n_rays, jnp.float32)
    maxt = jnp.full(n_rays, jnp.inf, jnp.float32)
    # shadow rays with finite extents: half of them end before the hit
    smax = jnp.asarray(np.linalg.norm(ext) * 3.0
                       * rng.uniform(size=n_rays), jnp.float32)

    @jax.jit
    def both(o, d, mint, maxt, smax):
        geom, bvh = scene.geometry, scene.bvh
        return (traverse.intersect_bvh(bvh, geom, o, d, mint, maxt),
                traverse.intersect_brute(geom, o, d, mint, maxt, F),
                traverse.ray_test_bvh(bvh, geom, o, d, mint, smax),
                traverse.ray_test_brute(geom, o, d, mint, smax, F))

    hb, hf, ob, of = jax.tree_util.tree_map(
        np.asarray, both(o, d, mint, maxt, smax))
    return compare_hits(hb, hf, ob, of)


def compare_hits(hb, hf, ob, of, rtol=1e-5):
    """BVH hits/occlusion (hb, ob) against brute force (hf, of): prim ids
    equal except on exact t-ties, t within rtol, occlusion identical."""
    import numpy as np

    hit_b, hit_f = hb["prim"] >= 0, hf["prim"] >= 0
    if not np.array_equal(hit_b, hit_f):
        raise AssertionError(
            f"hit sets differ on {int((hit_b != hit_f).sum())} rays")
    tb, tf = hb["t"][hit_f], hf["t"][hit_f]
    t_err = np.abs(tb - tf) / np.maximum(np.abs(tf), 1e-30)
    if float(t_err.max(initial=0.0)) > rtol:
        raise AssertionError(f"t differs by {float(t_err.max()):.3g} rel")
    prim_diff = hb["prim"] != hf["prim"]
    ties = prim_diff & hit_f  # t already agrees within rtol on these
    if not np.array_equal(ob, of):
        raise AssertionError(
            f"occlusion differs on {int((ob != of).sum())} rays")
    return dict(rays=int(hit_f.size), hits=int(hit_f.sum()),
                prim_ties=int(ties.sum()), max_t_rel=float(t_err.max(
                    initial=0.0)), occluded=int(of.sum()))


def train_phase():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from misaki_tpu.diff import get_leaves
    from misaki_tpu.parallel import sharding
    from misaki_tpu.scene.assets import scene_path
    from misaki_tpu.scene.compiler import load_and_compile

    scene = load_and_compile(scene_path("cbox"), spp=16, width=256,
                             height=256)
    mesh = sharding.make_mesh(1)
    target = np.zeros((scene.film_height, scene.film_width, 3), np.float32)
    scene_d = scene.replace(diff_mode=True)
    compile_s, mem = aot(
        sharding.train_loss_and_grads,
        get_leaves(scene_d, sharding.DEFAULT_TRAIN_LEAVES), scene_d,
        jnp.asarray(target), jnp.uint32(0), mesh=mesh, depth_cap=3)

    def step(seed):
        loss, grads = sharding.train_step_sharded(mesh, scene, target,
                                                  seed=seed, depth_cap=3)
        return jax.block_until_ready((loss, grads))

    t0 = time.perf_counter()
    step(0)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, grads = step(1)
    run_s = time.perf_counter() - t0
    grads = {k: np.asarray(v) for k, v in grads.items()}
    if not np.isfinite(float(loss)):
        raise AssertionError("train step: loss is not finite")
    if not all(np.isfinite(g).all() for g in grads.values()):
        raise AssertionError("train step: non-finite gradients")
    nonzero = [k for k, g in grads.items() if np.abs(g).sum() > 0]
    if not nonzero:
        raise AssertionError("train step: every gradient is zero")
    log(phase="train_step", size=[scene.film_width, scene.film_height],
        spp=scene.spp, depth_cap=3,
        compile_s=compile_s, first_s=first_s, run_s=run_s, memory=mem,
        loss=float(loss), nonzero_leaves=nonzero)


def parity_phase(reference):
    from tools.check_gpu_cpu_parity import FRAC_OFF, MEAN_REL, run_parity

    t0 = time.perf_counter()
    res = run_parity(verbose=False, reference=reference)
    log(phase="parity", seconds=time.perf_counter() - t0,
        bounds=dict(frac_off=FRAC_OFF, mean_rel=MEAN_REL), cases=res)
    bad = [k for k, s in res.items() if not s["ok"]]
    if bad:
        raise AssertionError(f"GPU and CPU differ: {bad}")


def one_card():
    from misaki_tpu.scene.assets import scene_path
    from misaki_tpu.scene.compiler import load_and_compile
    from tools.check_gpu_cpu_parity import (
        GRAD_CASE, SCENES, start_cpu_reference, stop_cpu_reference)

    # the CPU reference of phase 6 runs while the card works
    reference = start_cpu_reference(SCENES, GRAD_CASE)
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            cbox_phase(out_dir)
        bunny = load_and_compile(scene_path("bunny"))
        render_phase("bunny_debug", bunny, 2, integrator="debug")
        bunny_path = load_and_compile(scene_path("bunny"), spp=16, width=256,
                                      height=256).replace(integrator="path")
        render_phase("bunny_path", bunny_path, 4)
        t0 = time.perf_counter()
        stats = bvh_vs_brute(bunny)
        log(phase="bunny_bvh_vs_brute",
            seconds=time.perf_counter() - t0, **stats)
        fig2 = load_and_compile(scene_path("figure2_roughconductor"),
                                spp=16, width=320, height=180)
        render_phase("figure2", fig2, 4)
        train_phase()
        parity_phase(reference)
    finally:
        stop_cpu_reference(reference)


def four_cards():
    """cbox 800x600 at 64 spp through render_sharded on 4 cards against the
    one-card render of the same seed, and train_step_sharded on 4 cards
    against 1."""
    import jax
    import numpy as np

    from misaki_tpu.parallel.sharding import make_mesh, render_sharded
    from misaki_tpu.render import driver
    from misaki_tpu.scene.assets import scene_path
    from misaki_tpu.scene.compiler import load_and_compile
    from tools.check_gpu_cpu_parity import compare, train_grads

    mesh4 = make_mesh(4)
    scene = load_and_compile(scene_path("cbox"), spp=64)

    def sharded():
        return render_sharded(mesh4, scene, seed=3, depth_cap=4)

    first_s, _ = timed(sharded)
    run_s, film4 = timed(sharded)
    single_s, out = timed(lambda: driver.render(scene, seed=3,
                                                depth_cap=4)["film"])
    film4, film1 = np.asarray(film4), np.asarray(out)
    # The per-lane samples are the same; the order of the film sums differs
    # (psum over devices, chunk order), and the two programs are compiled
    # apart, so a rare sample whose branch (Russian roulette) sits on a
    # rounding edge may flip. Bounds: at most 0.5% of texels off by more
    # than 1e-5 of the film's largest value, and the film's total within
    # 1e-5 relative.
    scale = float(np.abs(film1).max())
    err = np.abs(film4 - film1) / scale
    image = dict(max_rel=float(err.max()), mean_rel=float(err.mean()),
                 frac_above_1e5=float((err > 1e-5).mean()),
                 total_rel=float(abs(film4.sum() - film1.sum())
                                 / abs(film1.sum())))
    log(phase="four_cards_render", size=[scene.film_width,
                                         scene.film_height],
        spp=scene.spp, first_s=first_s, run_s=run_s, one_card_s=single_s,
        **image)
    if image["frac_above_1e5"] > 0.005 or image["total_rel"] > 1e-5:
        raise AssertionError("4-card film differs from the 1-card film")

    case = ("cbox", dict(spp=16, width=256, height=256), 0, 3)
    t0 = time.perf_counter()
    g4 = train_grads(case, mesh4)
    g1 = train_grads(case, make_mesh(1))
    grads = {k: compare(g4[k], g1[k]) for k in g1}
    log(phase="four_cards_train_step", seconds=time.perf_counter() - t0,
        loss4=float(g4["loss"]), loss1=float(g1["loss"]), cases=grads)
    bad = [k for k, s in grads.items() if not s["ok"]]
    if bad:
        raise AssertionError(f"4-card gradients differ from 1-card: {bad}")
    return jax.devices()[:4]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on 4 cards")
    args = ap.parse_args(argv)

    devices = device_phase()
    sys.path.insert(0, ROOT)
    try:
        from misaki_tpu.utils.compile_cache import setup_compile_cache
    except ImportError:
        fail("the misaki_tpu package is not beside chip_smoke.py")
    setup_compile_cache()

    if args.four_cards:
        devices = four_cards()
    else:
        one_card()
        devices = devices[:1]
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
