#!/usr/bin/env python
"""Full-spec flagship renders: run the most feature-complete shipped
scenes AT THEIR DECLARED RESOLUTION/SPP and write the timings to RESULTS.md.

Workloads (each scene's own XML spec, scenes/):
  * teapot-full   — 1280x720 @ 128spp volpath (homogeneous media in glass,
                    constant env)
  * figure2       — 1280x720 @ 128spp path (roughconductor + checkerboard
                    + constant env)
  * figure3       — 1280x720 @ 128spp path (roughdielectric)

The scenes declare no max_depth (unbounded with RR); renders here cap the
bounce loop at depth 8, which RR makes statistically equivalent for these
scenes. Timing: full wall-clock of render() including chunk orchestration,
ended by block_until_ready; one warmup render compiles everything first.

Usage: timeout 3600 python tools/flagship_renders.py [--out-dir DIR]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from misaki_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

DEPTH_CAP = 8


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="chiprun_out/flagship")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="resolution scale for quick runs (1.0 = full spec)")
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    from misaki_tpu.scene.assets import scene_path
    from misaki_tpu.scene.compiler import load_and_compile
    from misaki_tpu.render.driver import render
    from misaki_tpu.render.integrator import n_bounce_iters
    from misaki_tpu.render.film import write_png

    jobs = [(name, scene_path(name)) for name in (
        "teapot-full", "figure2_roughconductor", "figure3_roughdielectric")]

    rows = []
    for name, path in jobs:
        kw = {}
        if args.scale != 1.0:
            sc0 = load_and_compile(path)
            kw = dict(width=max(int(sc0.film_width * args.scale), 16),
                      height=max(int(sc0.film_height * args.scale), 16))
        scene = load_and_compile(path, **kw)
        W, H, spp = scene.film_width, scene.film_height, scene.spp
        nb = n_bounce_iters(scene, DEPTH_CAP)
        rays = W * H * spp * (1 + 2 * nb)
        print(f"{name}: {W}x{H}@{spp}spp {scene.integrator} "
              f"depth_cap={DEPTH_CAP} ({rays/1e9:.2f} G rays)")
        out = render(scene, seed=0, depth_cap=DEPTH_CAP)   # warmup+compile
        out["rgb"].block_until_ready()
        t0 = time.perf_counter()
        out = render(scene, seed=1, depth_cap=DEPTH_CAP)
        out["rgb"].block_until_ready()
        dt = time.perf_counter() - t0
        rgb = np.asarray(out["rgb"])
        png = os.path.join(args.out_dir, f"{name}.png")
        write_png(png, rgb)
        rows.append((name, f"{W}x{H}@{spp}", scene.integrator, dt,
                     rays / dt, float(rgb.mean()),
                     float(np.isfinite(rgb).all())))
        print(f"  {dt:.1f} s wall  {rays/dt/1e6:.1f} M rays/s  "
              f"mean={rgb.mean():.4f}")

    lines = [
        "# RESULTS — full-spec flagship renders",
        "",
        f"Backend: {jax.default_backend()} "
        f"({jax.devices()[0].device_kind}), depth cap {DEPTH_CAP} "
        "(scenes declare unbounded depth + RR), wall-clock includes chunk "
        "orchestration and film develop; rays = samples x (1 + 2 x bounce "
        "iterations) as in bench.py.",
        "",
        "| scene | spec | integrator | wall s | M rays/s | image mean | finite |",
        "|---|---|---|---|---|---|---|",
    ]
    for name, spec, integ, dt, rps, mean, fin in rows:
        lines.append(f"| {name} | {spec} | {integ} | {dt:.1f} | "
                     f"{rps/1e6:.1f} | {mean:.4f} | "
                     f"{'yes' if fin else 'NO'} |")
    out_md = os.path.join(os.path.dirname(__file__), "..", "RESULTS.md")
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {os.path.abspath(out_md)}")


if __name__ == "__main__":
    main()
