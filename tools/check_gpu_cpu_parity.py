#!/usr/bin/env python
"""GPU <-> CPU parity: the same renders (and one inverse-rendering gradient)
on the accelerator and in a CPU subprocess, compared texel by texel.

The reference is the float32 CPU run with
`jax.default_matmul_precision("highest")`. The child process sets
JAX_PLATFORMS=cpu before it imports JAX, so it never opens the card.
Lane seeding is global and every table read is an exact gather, so the two
runs differ only in operation order (and, through it, in a few samples whose
branch — Russian roulette, a BVH tie — flips).

Usage: python tools/check_gpu_cpu_parity.py    (exit code 1 on mismatch)
"""

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

# name: (scene, compile overrides, seed, depth_cap)
SCENES = {
    "cbox": ("cbox", dict(spp=8, width=64, height=48), 3, 4),
    "bunny": ("bunny", dict(spp=4, width=96, height=96), 3, 2),
}
# the inverse-rendering step compared by gradients (L2 loss to a black image)
GRAD_CASE = ("cbox", dict(spp=16, width=64, height=48), 0, 3)

# Tolerances (those of tests/test_golden_images.py): at most FRAC_OFF of the
# values may differ by more than 1e-3 of the reference's largest magnitude,
# and the mean of that relative error is at most MEAN_REL.
FRAC_OFF = 0.02
MEAN_REL = 1e-3


def render_rgb(case):
    """(scene, kw, seed, depth) -> developed linear-RGB image (numpy)."""
    import numpy as np

    from misaki_tpu.render.driver import render
    from misaki_tpu.scene.assets import scene_path
    from misaki_tpu.scene.compiler import load_and_compile

    name, kw, seed, depth = case
    scene = load_and_compile(scene_path(name), **kw)
    return np.asarray(render(scene, seed=seed, depth_cap=depth)["rgb"])


def train_grads(case, mesh=None):
    """(scene, kw, seed, depth) -> {"loss": ..., leaf: grad} (numpy) of one
    train_step_sharded on `mesh` (default: one device)."""
    import numpy as np

    from misaki_tpu.parallel.sharding import make_mesh, train_step_sharded
    from misaki_tpu.scene.assets import scene_path
    from misaki_tpu.scene.compiler import load_and_compile

    name, kw, seed, depth = case
    scene = load_and_compile(scene_path(name), **kw)
    target = np.zeros((scene.film_height, scene.film_width, 3), np.float32)
    loss, grads = train_step_sharded(mesh or make_mesh(1), scene, target,
                                     seed=seed, depth_cap=depth)
    out = {k: np.asarray(v) for k, v in grads.items()}
    out["loss"] = np.asarray(loss)
    return out


_CHILD = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, %(root)r)
import jax
import numpy as np
from tools.check_gpu_cpu_parity import render_rgb, train_grads
with jax.default_matmul_precision("highest"):
    out = {}
    for key, case in %(renders)r.items():
        out["render/" + key] = render_rgb(case)
    if %(grad)r is not None:
        for key, v in train_grads(%(grad)r).items():
            out["grad/" + key] = v
np.savez(%(out)r, **out)
"""


def start_cpu_reference(renders, grad_case=None):
    """Start the CPU subprocess that runs `renders` ({key: case}) and
    `grad_case`; returns a handle for `cpu_reference_result`."""
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "cpu.npz")
    code = _CHILD % dict(root=ROOT, renders=renders, grad=grad_case, out=out)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env)
    return proc, tmp, out


def cpu_reference_result(handle, timeout=1500):
    """Wait for the child; -> {"render/<key>": rgb, "grad/<leaf>": grad,
    "grad/loss": loss}. The child is killed if it outlives `timeout`."""
    import numpy as np

    proc, _, out = handle
    try:
        rc = proc.wait(timeout=timeout)
        if rc != 0:
            raise RuntimeError(f"CPU reference process exited with {rc}")
        with np.load(out) as data:
            return {k: data[k] for k in data.files}
    finally:
        stop_cpu_reference(handle)


def stop_cpu_reference(handle):
    """Kill the child if it still runs and remove its files."""
    proc, tmp, _ = handle
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    tmp.cleanup()


def compare(got, want):
    """Texel statistics of `got` against the reference `want`."""
    import numpy as np

    scale = max(float(np.abs(want).max()), 1e-12)
    err = np.abs(np.asarray(got, np.float64) - want) / scale
    frac_off = float((err > 1e-3).mean())
    mean_rel = float(err.mean())
    return dict(frac_off=frac_off, mean_rel=mean_rel, max_rel=float(err.max()),
                ok=bool(frac_off <= FRAC_OFF and mean_rel <= MEAN_REL))


def run_parity(scene_names=None, grad_case=GRAD_CASE, verbose=True,
               reference=None):
    """Render SCENES (or the named subset) on the default backend and in a
    CPU subprocess, plus the one-device gradient of `grad_case` (None skips
    it); returns {key: stats with "ok"}. `reference` is a handle from
    start_cpu_reference for the same cases, started earlier so that the CPU
    work overlaps the caller's."""
    renders = {n: c for n, c in SCENES.items()
               if scene_names is None or n in scene_names}
    if reference is None:
        reference = start_cpu_reference(renders, grad_case)
    try:
        got = {"render/" + k: render_rgb(c) for k, c in renders.items()}
        if grad_case is not None:
            got.update({"grad/" + k: v
                        for k, v in train_grads(grad_case).items()})
    except BaseException:
        stop_cpu_reference(reference)
        raise
    ref = cpu_reference_result(reference)
    results = {k.removeprefix("render/"): compare(v, ref[k])
               for k, v in got.items()}
    if verbose:
        for key, stats in results.items():
            print(json.dumps(dict(case=key, **stats)))
    return results


def main():
    import jax

    from misaki_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    print(f"device: {jax.devices()[0].platform} {jax.devices()[0].device_kind}")
    results = run_parity()
    failed = [k for k, s in results.items() if not s["ok"]]
    for k in failed:
        print(f"FAIL: {k} differs between the device and the CPU")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
