"""Render driver: wavefront orchestration + film assembly
(reference: SamplingIntegrator::render, integrator.cpp:31-126 — the TBB
tile loop replaced by jit-batched wavefront chunks).

The full (pixels x spp) sample set is split into fixed-size lane chunks; one
jitted step function renders a chunk and scatter-adds it into the film, which
stays resident on device. Determinism: lane index == pixel * spp + sample,
and each lane's PCG32 stream is seeded by (lane, seed), so the image is
independent of chunk size and device placement.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from misaki_tpu.core import rng, spectrum as spec
from misaki_tpu.render import camera as cam
from misaki_tpu.render import film as film_mod
from misaki_tpu.render import integrator as integ

DEFAULT_CHUNK = 1 << 20


def make_rng(lane, seed):
    """Per-lane PCG32 streams: initstate = lane, initseq mixes the seed so
    different seeds give uncorrelated sequences."""
    seed32 = jnp.uint32(seed)
    return rng.seed(
        (seed32 * jnp.uint32(0x9E3779B9), lane.astype(jnp.uint32)),
        (lane.astype(jnp.uint32) ^ (seed32 * jnp.uint32(2654435761)), seed32 | jnp.uint32(1)),
    )


def primary_rays(scene, lane, seed):
    """Camera rays for global lane ids. Draw order matches the reference's
    render_sample (integrator.cpp:103-126): pixel jitter 2D, wavelength 1D,
    lens/aperture 2D (drawn but unused by the pinhole camera)."""
    spp = scene.spp
    pixel = lane // spp
    px = (pixel % scene.film_width).astype(jnp.float32)
    py = (pixel // scene.film_width).astype(jnp.float32)

    state = make_rng(lane, seed)
    jitter, state = rng.next_2d(state)
    wav_u, state = rng.next_float32(state)
    _lens, state = rng.next_2d(state)

    pos = (px + jitter[0], py + jitter[1])
    # crop window: the camera mapping spans the FULL sensor; film-local
    # positions are offset into it (film.cpp crop semantics)
    cam_pos = (pos[0] + scene.crop_x, pos[1] + scene.crop_y)
    ray = cam.sample_ray_differential(scene.camera, cam_pos, wav_u)
    return ray, pos, state


def _render_chunk(scene, film_flat, lane0, n_total, seed, chunk, depth_cap):
    """Render `chunk` lanes (spp-aligned) into the flat padded film."""
    lane = lane0 + jnp.arange(chunk, dtype=jnp.uint32)
    in_range = lane < n_total
    ray, pos, state = primary_rays(scene, lane, seed)

    if scene.integrator == "debug":
        rgb, state = integ.sample_debug(scene, ray, state)
        xyz = spec.srgb_to_xyz(rgb)
    else:
        if scene.integrator == "volpath":
            L_spec, state = integ.sample_volpath(scene, ray, state, depth_cap)
        elif scene.integrator == "direct":
            L_spec, state = integ.sample_direct(scene, ray, state)
        else:
            L_spec, state = integ.sample_path(scene, ray, state, depth_cap)
        L_spec = L_spec * ray["wav_weight"]
        xyz = spec.spectrum_to_xyz(L_spec, ray["wavelengths"])

    ones = jnp.ones(chunk)
    # XYZAW channels (integrator.cpp:119-123: alpha=1, filter weight=1)
    values = tuple(xyz) + (ones, ones)
    values = tuple(
        jnp.where(in_range & jnp.isfinite(c), c, 0.0) for c in values
    )
    if isinstance(lane0, int):
        pixel0 = lane0 // scene.spp      # static: enables the fused splat
    else:
        pixel0 = (lane0 // scene.spp).astype(jnp.int32)
    return film_mod.splat_aligned(
        film_flat, pixel0, pos, values,
        scene.film_width, scene.film_height, scene.spp,
        scene.filter_type, scene.filter_stddev,
    )


@partial(
    jax.jit,
    static_argnames=("n_total", "chunk", "depth_cap"),
    donate_argnames=("film_flat",),
)
def render_chunk(scene, film_flat, lane0, n_total, seed, chunk, depth_cap):
    return _render_chunk(scene, film_flat, lane0, n_total, seed, chunk, depth_cap)


def pick_chunk(chunk_size, spp, n_total):
    """Largest spp-multiple <= chunk_size (min spp) so chunks stay
    pixel-aligned for the dense splat."""
    chunk = max(spp, (chunk_size // spp) * spp)
    return min(chunk, -(-n_total // spp) * spp)


def _scene_fingerprint(scene, seed, depth_cap, chunk):
    """Cheap checkpoint-compatibility fingerprint: static config + geometry
    size. A resumed render with a different scene/seed must be rejected.
    `chunk` (the RESOLVED pick_chunk value) is part of the identity:
    next_chunk indexes chunk-sized lane ranges, so resuming under a
    different chunk size silently skips / double-accumulates samples
    (advisor r3 #3)."""
    return (
        f"{scene.film_width}x{scene.film_height}x{scene.spp}"
        f"|{scene.integrator}|{scene.max_depth}|{scene.n_faces}"
        f"|{scene.n_emitters}|seed={seed}|cap={depth_cap}|chunk={chunk}"
    )


def save_checkpoint(path, film_flat, next_chunk, fingerprint):
    """Atomic film+progress snapshot (SURVEY.md section 5: the preemption
    recovery the reference never had). The per-lane RNG needs no state in the
    file: streams are derived from (lane, seed), so resuming chunk c
    regenerates them exactly."""
    import os
    import numpy as np

    tmp = f"{path}.tmp.npz"
    np.savez(tmp, film_flat=np.asarray(film_flat),
             next_chunk=np.int64(next_chunk),
             fingerprint=np.array(fingerprint))
    os.replace(tmp, path)


def load_checkpoint(path, fingerprint):
    """-> (film_flat, next_chunk) or None if absent/incompatible."""
    import os
    import numpy as np

    if not os.path.exists(path):
        return None
    data = np.load(path, allow_pickle=False)
    if str(data["fingerprint"]) != fingerprint:
        from misaki_tpu.utils.logging import get_logger

        get_logger().warning(
            "checkpoint %s does not match this render (have %r, want %r) — "
            "starting fresh", path, str(data["fingerprint"]), fingerprint,
        )
        return None
    return jnp.asarray(data["film_flat"]), int(data["next_chunk"])


def render(
    scene,
    seed=0,
    chunk_size=DEFAULT_CHUNK,
    depth_cap=integ.DEFAULT_MAX_DEPTH_CAP,
    checkpoint_path=None,
    checkpoint_every=8,
    progress=None,
):
    """Render the scene; returns dict with the raw film and developed image.
    An `aov` integrator dispatches to the AOV driver (aov.cpp semantics) and
    additionally returns {"aovs": {name: (H, W, C)}}.

    checkpoint_path: when set, the accumulated film is snapshotted every
    `checkpoint_every` chunks and the render resumes from the snapshot if a
    compatible one exists (kill -9 mid-render -> resume -> bit-identical
    image, because chunk order and per-lane RNG streams are deterministic).
    progress: optional callable(done_chunks, total_chunks) for long renders;
    defaults to log lines every ~10% when the render has multiple chunks."""
    if scene.integrator in ("sppm", "photonmapper"):
        from misaki_tpu.render.ppm import render_ppm

        # checkpoint/progress are honored per ITERATION by the ppm driver
        # (chunk_size has no meaning there — the wavefront is one camera
        # sample per pixel; advisor r4 #5)
        return render_ppm(scene, seed=seed, depth_cap=depth_cap,
                          checkpoint_path=checkpoint_path,
                          checkpoint_every=checkpoint_every,
                          progress=progress)
    if scene.integrator == "aov":
        from misaki_tpu.render.aov import render_aovs

        out = render_aovs(
            scene, seed=seed, chunk_size=chunk_size,
            include_rgb=True, depth_cap=depth_cap,
        )
        return {
            "film": None,
            "rgb": jnp.asarray(out["rgb"]),
            "alpha": jnp.asarray(out["alpha"]),
            "aovs": out["aovs"],
        }
    W, H, spp = scene.film_width, scene.film_height, scene.spp
    n_total = W * H * spp
    chunk = pick_chunk(chunk_size, spp, n_total)

    n_chunks = -(-n_total // chunk)
    if n_chunks == 1:
        # single-chunk frame: film init + render + develop in ONE dispatch
        film, rgb, alpha = render_frame_single(
            scene, n_total, jnp.uint32(seed), chunk, depth_cap
        )
        return {"film": film, "rgb": rgb, "alpha": alpha}

    start_chunk = 0
    film_flat = None
    fingerprint = _scene_fingerprint(scene, seed, depth_cap, chunk)
    if checkpoint_path is not None:
        resumed = load_checkpoint(checkpoint_path, fingerprint)
        if resumed is not None:
            film_flat, start_chunk = resumed
            from misaki_tpu.utils.logging import get_logger

            get_logger().info(
                "resuming from %s at chunk %d/%d",
                checkpoint_path, start_chunk, n_chunks,
            )
    if film_flat is None:
        film_flat = film_mod.new_film_flat(
            H, W, 5, scene.filter_type, scene.filter_stddev
        )

    if progress is None and n_chunks > 1:
        from misaki_tpu.utils.logging import get_logger

        log = get_logger()
        step = max(1, n_chunks // 10)

        def progress(done, total):  # noqa: F811 - default reporter
            if done % step == 0 or done == total:
                log.info("render progress: %d/%d chunks (%.0f%%)",
                         done, total, 100.0 * done / total)

    for c in range(start_chunk, n_chunks):
        film_flat = render_chunk(
            scene,
            film_flat,
            jnp.uint32(c * chunk),
            n_total,
            jnp.uint32(seed),
            chunk,
            depth_cap,
        )
        if progress is not None:
            progress(c + 1, n_chunks)
        if (checkpoint_path is not None and checkpoint_every > 0
                and (c + 1) % checkpoint_every == 0 and c + 1 < n_chunks):
            save_checkpoint(checkpoint_path, film_flat, c + 1, fingerprint)
    if checkpoint_path is not None:
        import os

        if os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)  # completed: snapshot is stale
    film, rgb, alpha = develop_film(
        film_flat, H, W, scene.filter_type, scene.filter_stddev
    )
    return {"film": film, "rgb": rgb, "alpha": alpha}


@partial(jax.jit, static_argnames=("n_total", "chunk", "depth_cap"))
def render_frame_single(scene, n_total, seed, chunk, depth_cap):
    """Whole-frame render for single-chunk wavefronts (one XLA program)."""
    H, W = scene.film_height, scene.film_width
    film_flat = film_mod.new_film_flat(
        H, W, 5, scene.filter_type, scene.filter_stddev
    )
    # lane0 = 0 as a PYTHON int: the splat's tap offsets become static, so
    # the whole (2r+1)^2-tap gaussian accumulates in one fused pass
    # (film.splat_aligned static-offset path)
    film_flat = _render_chunk(
        scene, film_flat, 0, n_total, seed, chunk, depth_cap
    )
    film = film_mod.film_from_flat(
        film_flat, H, W, scene.filter_type, scene.filter_stddev
    )
    rgb, alpha = film_mod.develop(film)
    return film, rgb, alpha


@partial(jax.jit, static_argnames=("H", "W", "filter_type", "stddev"))
def develop_film(film_flat, H, W, filter_type, stddev):
    """film assembly + XYZ->sRGB development in ONE jit call (instead of a
    frame's worth of small eager dispatches)."""
    film = film_mod.film_from_flat(film_flat, H, W, filter_type, stddev)
    rgb, alpha = film_mod.develop(film)
    return film, rgb, alpha
