"""Command-line renderer — the reference's misaki-cli (src/apps/main.cpp)
rebuilt: load scene XML, render on the available accelerator, develop to
EXR (hdrfilm) or PNG (rgbfilm).

Unlike the reference (hardcoded scene path, no flags, main.cpp:66), this is a
proper CLI:

    python -m misaki_tpu.cli scene.xml -o out.exr --spp 64 --depth 8
"""

import argparse
import sys
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description="misaki_tpu renderer")
    p.add_argument("scene", help="Mitsuba-style scene XML")
    p.add_argument("-o", "--output", default=None, help="output image path")
    p.add_argument("--spp", type=int, default=None, help="override samples/pixel")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--depth", type=int, default=16, help="bounce cap for max_depth=-1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk-log2", type=int, default=20, help="wavefront chunk size")
    p.add_argument(
        "-D", "--define", action="append", default=[], metavar="KEY=VAL",
        help="scene $parameter substitution",
    )
    p.add_argument(
        "--checkpoint", default=None, metavar="PATH",
        help="film snapshot path: written periodically during the render "
             "and resumed from automatically if present (preemption "
             "recovery; the finished image is bit-identical)",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=8, metavar="N",
        help="snapshot every N wavefront chunks (default 8)",
    )
    p.add_argument(
        "-I", "--include-dir", action="append", default=[], metavar="DIR",
        help="extra file-resolver search path (meshes/textures/includes)",
    )
    args = p.parse_args(argv)

    from misaki_tpu.utils.compile_cache import setup_compile_cache
    from misaki_tpu.utils.logging import Timer, get_logger
    from misaki_tpu.scene.compiler import load_and_compile
    from misaki_tpu.render import film as film_mod
    from misaki_tpu.render.driver import render

    setup_compile_cache()
    log = get_logger()
    params = dict(kv.split("=", 1) for kv in args.define)
    if args.include_dir:
        from misaki_tpu.utils.fresolver import get_file_resolver

        for d in args.include_dir:
            get_file_resolver().append(d)

    t = Timer()
    scene = load_and_compile(
        args.scene, params, spp=args.spp, width=args.width, height=args.height
    )
    log.info(
        "Compiled scene: %d faces, %d shapes, %d emitters (%s integrator) in %s",
        scene.n_faces, scene.n_shapes, scene.n_emitters, scene.integrator, t,
    )

    t.reset()
    log.info(
        "Starting render job (%dx%d, %d samples)",
        scene.film_width, scene.film_height, scene.spp,
    )
    out = render(
        scene, seed=args.seed, chunk_size=1 << args.chunk_log2,
        depth_cap=args.depth, checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
    )
    out["rgb"].block_until_ready()
    log.info("Rendering finished. (took %s)", t)

    dest = args.output
    if dest is None:
        ext = ".exr" if scene.film_format == "hdrfilm" else ".png"
        dest = str(Path(args.scene).with_suffix(ext))
    log.info("Developing %s ..", dest)
    if dest.endswith(".png"):
        film_mod.write_png(dest, out["rgb"])
    else:
        film_mod.write_exr(dest, out["rgb"], out["alpha"])
    # AOV integrator: one EXR per variable next to the main image
    # (the reference packs them as extra film channels, aov.cpp:61-85)
    for name, img in out.get("aovs", {}).items():
        aov_dest = str(Path(dest).with_suffix("")) + f"_{name}.exr"
        log.info("Writing AOV %s -> %s", name, aov_dest)
        import numpy as np

        if img.shape[-1] == 2:  # uv -> pad to RGB for a portable EXR
            img = np.concatenate([img, np.zeros_like(img[..., :1])], -1)
        film_mod.write_exr(aov_dest, img[..., 0] if img.shape[-1] == 1 else img)
    return 0


if __name__ == "__main__":
    sys.exit(main())
