#!/usr/bin/env python
"""Benchmark: rays/s on the cbox 4-bounce path trace, plus the bunny
intersection rate and the figure2 rough-conductor path trace.

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra",
"gpu_cpu_parity"}. Any failing scene or parity check fails the run.

Ray accounting mirrors what the workload actually casts per sample:
  1 camera ray + per bounce iteration (closest-hit ray + shadow ray).
With depth_cap bounces the expected count per sample is
  1 + sum_{i<n_iters} active_frac_i * 2  — we count conservatively using the
static structure (1 camera + n_iters * 2), i.e. rays *offered* to the
intersector per lane; masked-off lanes still traverse in lockstep, so this
is also the true hardware work.
"""

import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from misaki_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()


def _time_render(scene, depth_cap, chunk, reps):
    """Mean seconds per render after one warmup (compile) render; the
    renders are seeded differently and synced with block_until_ready."""
    from misaki_tpu.render.driver import render

    render(scene, seed=0, chunk_size=chunk,
           depth_cap=depth_cap)["rgb"].block_until_ready()
    t0 = time.perf_counter()
    for i in range(reps):
        out = render(scene, seed=i + 1, chunk_size=chunk, depth_cap=depth_cap)
    out["rgb"].block_until_ready()
    return (time.perf_counter() - t0) / reps


def main():
    spp = int(os.environ.get("BENCH_SPP", 64))
    width = int(os.environ.get("BENCH_W", 256))
    height = int(os.environ.get("BENCH_H", 256))
    depth_cap = int(os.environ.get("BENCH_DEPTH", 4))  # 4-bounce path trace
    chunk = 1 << int(os.environ.get("BENCH_CHUNK_LOG2", 20))

    from misaki_tpu.render.integrator import n_bounce_iters
    from misaki_tpu.scene.assets import scene_path
    from misaki_tpu.scene.compiler import load_and_compile

    scene = load_and_compile(scene_path("cbox"), spp=spp, width=width,
                             height=height)
    # max_depth -1 in the scene: cap at depth_cap+1 so n_bounce_iters == depth_cap
    scene = scene.replace(max_depth=depth_cap + 1)
    dt = _time_render(scene, depth_cap, chunk,
                      int(os.environ.get("BENCH_REPS", 3)))
    rays_per_s = width * height * spp * (1 + depth_cap * 2) / dt

    extra = {}
    if os.environ.get("BENCH_EXTRA", "1") != "0":
        # extra-scene depths are PINNED: figure2's XML declares no
        # max_depth, so inheriting the headline depth_cap would silently
        # change this metric's meaning whenever BENCH_DEPTH moves
        for name, scene_name, reps, depth, kw in (
            ("bunny_debug_rays_per_s", "bunny", 15, 4, {}),
            ("figure2_roughconductor_rays_per_s", "figure2_roughconductor",
             3, 4, dict(spp=16, width=320, height=180)),
        ):
            sc = load_and_compile(scene_path(scene_name), **kw)
            d = _time_render(sc, depth, chunk, reps)
            # rays/sample from the scene actually rendered: the debug
            # integrator casts the camera ray only; path-style integrators
            # run n_bounce_iters (closest+shadow each) bounded by the
            # scene's own max_depth, NOT the headline run's depth_cap
            rps = (1 if sc.integrator == "debug"
                   else 1 + 2 * n_bounce_iters(sc, depth))
            extra[name] = sc.film_width * sc.film_height * sc.spp * rps / d

    parity = "skipped"
    if os.environ.get("BENCH_PARITY", "1") != "0":
        from tools.check_gpu_cpu_parity import run_parity

        res = run_parity(scene_names=("bunny",), grad_case=None,
                         verbose=False)
        parity = res
        if not all(s["ok"] for s in res.values()):
            print(json.dumps({"gpu_cpu_parity": res}), file=sys.stderr)
            sys.exit("bench: the device image differs from the CPU reference")

    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "cbox_4bounce_rays_per_s",
                "value": rays_per_s,
                "unit": "rays/s",
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "extra": extra,
                "gpu_cpu_parity": parity,
            }
        )
    )


if __name__ == "__main__":
    main()
