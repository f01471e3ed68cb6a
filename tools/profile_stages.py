#!/usr/bin/env python
"""Per-stage timing harness for the render pipeline ("instrument first,
then optimize" — the optimization loop needs a gauge).

Times each pipeline stage as an independent jitted function over one
representative chunk of lanes, synced by a host transfer of a scalar that
depends on every output.

Usage:
  python tools/profile_stages.py [scene.xml] [--spp N] [--chunk-log2 N]
  JAX_PROFILER_DIR=/tmp/trace python tools/profile_stages.py  # + jax.profiler
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from misaki_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

from misaki_tpu.scene.assets import scene_path  # noqa: E402


def scalarize(fn):
    """Wrap fn so the jitted computation reduces every output leaf to one
    scalar on-device: host syncs then transfer 4 bytes, not the outputs
    (the download of a (46, 1M) array would be timed with the stage)."""

    @jax.jit
    def wrapped(*args):
        out = fn(*args)
        leaves = [jnp.sum(x.astype(jnp.float32))
                  for x in jax.tree_util.tree_leaves(out)
                  if hasattr(x, "dtype")]
        return sum(leaves)

    return wrapped


def timeit(fn, *args, reps=5, warmup=1):
    """Median wall time of fn(*args) with a hard sync per rep."""
    for _ in range(warmup):
        out = fn(*args)
        np.asarray(jax.tree_util.tree_leaves(out)[0])
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        np.asarray(jax.tree_util.tree_leaves(out)[0])
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default=scene_path("cbox"))
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--chunk-log2", type=int, default=20)
    args = ap.parse_args()

    from misaki_tpu.scene.compiler import load_and_compile
    from misaki_tpu.render import driver, film as film_mod, integrator as integ
    from misaki_tpu.render import interaction as inter
    from misaki_tpu.accel import traverse
    from misaki_tpu.bsdf import kernels as bsdf
    from misaki_tpu.emitter import kernels as emitter
    from misaki_tpu.core import rng, spectrum as spec, table

    scene = load_and_compile(args.scene, spp=args.spp, width=args.width,
                             height=args.height)
    scene = scene.replace(max_depth=args.depth + 1)
    chunk = min(1 << args.chunk_log2,
                driver.pick_chunk(1 << args.chunk_log2, scene.spp,
                                  scene.film_width * scene.film_height * scene.spp))
    L = chunk
    print(f"scene={args.scene}  L={L}  backend={jax.default_backend()}")

    lane = jnp.arange(L, dtype=jnp.uint32)

    @jax.jit
    def gen_rays():
        return driver.primary_rays(scene, lane, jnp.uint32(0))

    ray, pos, state = gen_rays()
    ray = jax.tree_util.tree_map(lambda x: x.block_until_ready(), ray)
    wavelengths = ray["wavelengths"]

    def stage_intersect():
        return traverse.intersect(scene, ray["o"], ray["d"], ray["mint"],
                                  ray["maxt"])

    hit = jax.jit(stage_intersect)()

    def stage_interaction():
        return inter.compute_interaction(scene, hit, ray["o"], ray["d"],
                                         wavelengths)

    si = jax.jit(stage_interaction)()

    def stage_matparams():
        return bsdf.material_params(scene, si["bsdf"], si["uv"], wavelengths)

    p = jax.jit(stage_matparams)()
    # restore the static fields the jit boundary turned into arrays
    # ("kinds" is a trace-time pruning tuple; "diff" a Python bool) — the
    # bsdf kernels branch on them with Python `in`/`if`
    p = dict(p)
    p["kinds"] = tuple(getattr(scene, "bsdf_kinds", ()))
    p["diff"] = bool(getattr(scene, "diff_mode", False))
    if p.get("mask") is not None and not hasattr(p["mask"], "dtype"):
        p["mask"] = None

    def stage_nee_sample():
        u2 = (jnp.full((L,), 0.3), jnp.full((L,), 0.6))
        return emitter.sample_emitter_direct(scene, si["p"], wavelengths, u2)

    ds = jax.jit(stage_nee_sample)()

    def stage_raytest():
        return traverse.ray_test(scene, si["p"], ds["d"],
                                 jnp.full((L,), 1e-4), ds["dist"])

    def stage_bsdf_eval():
        from misaki_tpu.core import frame
        wo = frame.to_local(si["sh"], ds["d"])
        return bsdf.eval_bsdf(p, si["wi"], wo), bsdf.pdf_bsdf(p, si["wi"], wo)

    def stage_bsdf_sample():
        u2 = (jnp.full((L,), 0.3), jnp.full((L,), 0.6))
        return bsdf.sample_bsdf(p, si["wi"], jnp.full((L,), 0.4), u2)

    def stage_emitter_eval():
        return emitter.eval_emitter(scene, si["emitter"], si["wi"], si["uv"],
                                    wavelengths)

    def stage_fetch_face():
        return inter.fetch_face(scene, hit["prim"])

    def stage_hat_radiance():
        return emitter.radiance(scene, 0, wavelengths)

    def stage_spectrum_to_xyz():
        return spec.spectrum_to_xyz(jnp.ones((4, L)), wavelengths)

    def stage_splat():
        film_flat = film_mod.new_film_flat(scene.film_height, scene.film_width,
                                           5, scene.filter_type,
                                           scene.filter_stddev)
        ones = jnp.ones(L)
        vals = (ones, ones, ones, ones, ones)
        return film_mod.splat_aligned(film_flat, jnp.int32(0), pos, vals,
                                      scene.film_width, scene.film_height,
                                      scene.spp, scene.filter_type,
                                      scene.filter_stddev)

    def full_path():
        return integ.sample_path(scene, ray, state, args.depth)

    def full_chunk(film_flat):
        return driver._render_chunk(scene, film_flat, jnp.uint32(0), L,
                                    jnp.uint32(0), L, args.depth)

    film0 = film_mod.new_film_flat(scene.film_height, scene.film_width, 5,
                                   scene.filter_type, scene.filter_stddev)

    stages = [
        ("primary_rays", gen_rays, ()),
        ("intersect (1x)", stage_intersect, ()),
        ("ray_test (1x)", stage_raytest, ()),
        ("interaction (1x)", stage_interaction, ()),
        ("fetch_face (1x)", stage_fetch_face, ()),
        ("material_params (1x)", stage_matparams, ()),
        ("nee_sample (1x)", stage_nee_sample, ()),
        ("bsdf_eval+pdf (1x)", stage_bsdf_eval, ()),
        ("bsdf_sample (1x)", stage_bsdf_sample, ()),
        ("emitter_eval (1x)", stage_emitter_eval, ()),
        ("hat_radiance (1x)", stage_hat_radiance, ()),
        ("spectrum_to_xyz", stage_spectrum_to_xyz, ()),
        ("splat", stage_splat, ()),
        ("integrator (full)", full_path, ()),
        ("render_chunk (full)", full_chunk, (film0,)),
    ]

    trace_dir = os.environ.get("JAX_PROFILER_DIR")
    results = {}
    for name, fn, fargs in stages:
        try:
            dt = timeit(scalarize(fn), *fargs)
            results[name] = dt
            print(f"{name:26s} {dt * 1e3:9.3f} ms")
        except Exception as e:
            print(f"{name:26s} FAILED: {e}")

    nb = integ.n_bounce_iters(scene, args.depth)
    per_bounce = ["intersect (1x)", "ray_test (1x)", "interaction (1x)",
                  "material_params (1x)", "nee_sample (1x)",
                  "bsdf_eval+pdf (1x)", "bsdf_sample (1x)", "emitter_eval (1x)"]
    est = sum(results.get(k, 0.0) for k in per_bounce) * nb
    est += results.get("primary_rays", 0) + results.get("intersect (1x)", 0)
    est += results.get("spectrum_to_xyz", 0) + results.get("splat", 0)
    print(f"\nbounces={nb}  sum-of-stages estimate: {est * 1e3:.1f} ms "
          f"vs measured chunk: {results.get('render_chunk (full)', 0) * 1e3:.1f} ms")
    rays = L // scene.spp * scene.spp * (1 + 2 * nb)
    if "render_chunk (full)" in results:
        print(f"chunk rays/s: {rays / results['render_chunk (full)'] / 1e6:.1f} M")

    if trace_dir:
        with jax.profiler.trace(trace_dir):
            full_chunk(film0).block_until_ready()
        print(f"profiler trace written to {trace_dir}")


if __name__ == "__main__":
    main()
