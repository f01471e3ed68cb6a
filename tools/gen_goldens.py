#!/usr/bin/env python
"""Generate the committed golden renders (tests/goldens/*.npz) used by
tests/test_golden_images.py: image parity with teeth.

Run on the CPU backend (the GPU-vs-CPU identity is checked separately by
tools/check_gpu_cpu_parity.py): renders each shipped scene at a small fixed
configuration and a fixed seed and stores the linear-RGB image. The test
re-renders with identical settings and asserts closeness — any regression
in materials / emitters / sampling / film shows up as a diff.

Regenerate ONLY when an intentional change alters images, and say so in the
commit message.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

GOLDENS = {
    # name: (scene name, dict of compile overrides, seed, depth_cap)
    "cbox": ("cbox", dict(spp=16, width=64, height=48), 7, 4),
    "figure2_roughconductor": ("figure2_roughconductor",
                               dict(spp=8, width=96, height=54), 7, 4),
    "figure3_roughdielectric": ("figure3_roughdielectric",
                                dict(spp=8, width=96, height=54), 7, 6),
    "teapot_volpath": ("teapot-full", dict(spp=8, width=64, height=36), 7, 6),
    "bunny_debug": ("bunny", dict(spp=4, width=64, height=64), 7, 2),
}


def render_golden(name):
    from misaki_tpu.scene.assets import scene_path
    from misaki_tpu.scene.compiler import load_and_compile
    from misaki_tpu.render.driver import render

    scene_name, kw, seed, depth = GOLDENS[name]
    scene = load_and_compile(scene_path(scene_name), **kw)
    out = render(scene, seed=seed, depth_cap=depth)
    return np.asarray(out["rgb"], np.float32)


def main():
    outdir = os.path.join(os.path.dirname(__file__), "..", "tests", "goldens")
    os.makedirs(outdir, exist_ok=True)
    only = sys.argv[1:] or list(GOLDENS)
    for name in only:
        rgb = render_golden(name)
        np.savez_compressed(os.path.join(outdir, f"{name}.npz"), rgb=rgb)
        print(f"{name}: {rgb.shape} mean={rgb.mean():.4f} -> goldens/{name}.npz")


if __name__ == "__main__":
    main()
