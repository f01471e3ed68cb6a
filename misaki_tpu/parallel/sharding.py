"""Multi-device rendering: shard the (pixels x spp) wavefront over a device
mesh (SURVEY.md section 2.6 / 5: the reference's only parallelism is TBB
tiles on one CPU; here `shard_map` splits the lanes over devices and psums
the film and the parameter gradients).

Design:
  * scene + BVH are replicated on every device (they are small relative to
    device memory; the wavefront dominates);
  * the global lane space [0, W*H*spp) is split contiguously per device;
    each device renders its lanes in chunk-sized blocks and splats them
    into a local film copy;
  * films are `psum` reduced — exact, because splatting is additive;
  * in the backward pass, AD transposes the replicated-parameter broadcast
    into a gradient psum automatically (the all-reduce the reference never
    had).
Determinism: lane seeding is global (driver.make_rng), so the image is
bit-identical for any device count modulo float-add ordering in the psum.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from misaki_tpu.render import film as film_mod
from misaki_tpu.render.driver import DEFAULT_CHUNK, _render_chunk, pick_chunk


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Multi-host initialization — `jax.distributed.initialize` with
    explicit coordination parameters (SURVEY.md section 2.6: the reference
    has no multi-host story; here every host runs the same SPMD program and
    the film psum spans all hosts' devices).

    Safe to call on a single host: a no-op when num_processes == 1."""
    if num_processes in (None, 1) and coordinator is None:
        return  # single-process run: nothing to coordinate
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_host_chip_mesh(axis_names=("host", "chip")):
    """2D (host, device) mesh over all global devices: shard the wavefront
    over the devices within a host and over hosts. Single-host runs
    degenerate to (1, n_local) and behave exactly like the 1D mesh."""
    devices = np.asarray(jax.devices())
    n_hosts = max(jax.process_count(), 1)
    per_host = len(devices) // n_hosts
    return Mesh(devices.reshape(n_hosts, per_host), axis_names)


def make_mesh(n_devices, axis_name="wavefront"):
    """1D mesh over the first n devices of the default backend. Raises when
    it has fewer than n devices."""
    devices = jax.devices()
    if len(devices) < n_devices:
        raise ValueError(
            f"need {n_devices} {devices[0].platform} devices, "
            f"have {len(devices)}"
        )
    return Mesh(np.asarray(devices[:n_devices]), (axis_name,))


def _lane_blocks(scene, n_dev, chunk_size):
    """-> (n_total, chunk, n_chunks): every device renders n_chunks
    spp-aligned chunks of `chunk` lanes, starting at dev * n_chunks * chunk.
    Lanes past n_total are masked by the chunk renderer."""
    n_total = scene.film_width * scene.film_height * scene.spp
    per_dev = -(-n_total // n_dev)
    chunk = pick_chunk(chunk_size, scene.spp, per_dev)
    return n_total, chunk, -(-per_dev // chunk)


def _render_device_block(scene, lane0, n_total, seed, chunk, n_chunks,
                         depth_cap):
    """One device's film: its lane block rendered chunk by chunk (the film
    is additive, so the chunking changes no pixel)."""
    film_flat = film_mod.new_film_flat(
        scene.film_height, scene.film_width, 5, scene.filter_type,
        scene.filter_stddev,
    )

    def body(c, film_flat):
        start = lane0 + jnp.uint32(chunk) * c.astype(jnp.uint32)
        return _render_chunk(scene, film_flat, start, n_total,
                             jnp.uint32(seed), chunk=chunk,
                             depth_cap=depth_cap)

    if n_chunks == 1:
        return body(jnp.int32(0), film_flat)
    return jax.lax.fori_loop(0, n_chunks, body, film_flat)


@partial(jax.jit, static_argnames=("mesh", "depth_cap", "axis_name",
                                   "chunk_size"))
def render_sharded(mesh, scene, seed=0, depth_cap=8, axis_name="wavefront",
                   chunk_size=DEFAULT_CHUNK):
    """Forward sharded render -> full film (replicated)."""
    W, H = scene.film_width, scene.film_height
    n_dev = mesh.devices.size
    n_total, chunk, n_chunks = _lane_blocks(scene, n_dev, chunk_size)
    lane0s = jnp.arange(n_dev, dtype=jnp.uint32) * jnp.uint32(chunk * n_chunks)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name)),
        out_specs=P(),
        # The integrator's fori_loop carries start as replicated constants
        # (throughput = ones) and become device-varying after one bounce;
        # the vma type check rejects that even though the program is correct
        # (every lane's carry is derived from its own sharded rays). Skip it.
        check_vma=False,
    )
    def shard_fn(scene, lane0_block):
        film_flat = _render_device_block(
            scene, lane0_block[0], n_total, seed, chunk, n_chunks, depth_cap
        )
        return jax.lax.psum(film_flat, axis_name)

    film_flat = shard_fn(scene, lane0s)
    return film_mod.film_from_flat(
        film_flat, H, W, scene.filter_type, scene.filter_stddev
    )


DEFAULT_TRAIN_LEAVES = ("materials", "rad_coeff", "rad_curve")


@partial(jax.jit, static_argnames=("mesh", "depth_cap", "axis_names",
                                   "chunk_size"))
def render_sharded_2d(mesh, scene, seed=0, depth_cap=8,
                      axis_names=("host", "chip"), chunk_size=DEFAULT_CHUNK):
    """Forward render over a 2D (host, device) mesh (make_host_chip_mesh):
    lanes are split host-major then device-minor — the flattened split is
    identical to the 1D mesh's, so images match bit-for-bit modulo psum
    ordering; the film reduction psums over the devices within a host
    first, then across hosts. Smoke-testable on the virtual CPU mesh
    (tests/conftest.py)."""
    W, H = scene.film_width, scene.film_height
    n_host, n_chip = mesh.devices.shape
    n_total, chunk, n_chunks = _lane_blocks(scene, n_host * n_chip,
                                            chunk_size)
    lane0s = (jnp.arange(n_host * n_chip, dtype=jnp.uint32)
              .reshape(n_host, n_chip) * jnp.uint32(chunk * n_chunks))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(*axis_names)),
        out_specs=P(),
        check_vma=False,  # see render_sharded
    )
    def shard_fn(scene, lane0_block):
        film_flat = _render_device_block(
            scene, lane0_block[0, 0], n_total, seed, chunk, n_chunks,
            depth_cap,
        )
        film_flat = jax.lax.psum(film_flat, axis_names[1])  # within a host
        return jax.lax.psum(film_flat, axis_names[0])       # across hosts

    film_flat = shard_fn(scene, lane0s)
    return film_mod.film_from_flat(
        film_flat, H, W, scene.filter_type, scene.filter_stddev
    )


@partial(jax.jit, static_argnames=("mesh", "depth_cap", "axis_name"))
def train_loss_and_grads(values, scene_d, target, seed, mesh, depth_cap,
                         axis_name="wavefront"):
    """The jitted body of `train_step_sharded`: L2 image loss of the sharded
    render with `values` swapped into `scene_d`, and its gradients."""
    from misaki_tpu.diff import replace_leaves

    def loss_fn(values):
        scene2 = replace_leaves(scene_d, values)
        film = render_sharded(mesh, scene2, seed, depth_cap, axis_name)
        rgb, _ = film_mod.develop(film)
        return jnp.mean((rgb - target) ** 2)

    return jax.value_and_grad(loss_fn)(values)


def train_step_sharded(mesh, scene, target_rgb, seed=0, depth_cap=4,
                       axis_name="wavefront", leaves=DEFAULT_TRAIN_LEAVES):
    """One differentiable training step: sharded render -> L2 image loss ->
    gradients w.r.t. the requested differentiable parameter leaves
    (misaki_tpu.diff.DIFF_LEAVES: packed material columns, emitter radiance
    coeffs/curves, envmap texels, medium sigma amplitudes/scales).

    The scene is flipped into diff_mode so microfacet alpha participates via
    the detached-sampling estimator (see misaki_tpu/diff/__init__.py)."""
    from misaki_tpu.diff import get_leaves

    scene_d = scene.replace(diff_mode=True)
    return train_loss_and_grads(
        get_leaves(scene_d, leaves), scene_d, jnp.asarray(target_rgb),
        jnp.uint32(seed), mesh=mesh, depth_cap=depth_cap, axis_name=axis_name,
    )
