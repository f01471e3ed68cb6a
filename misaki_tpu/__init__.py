"""misaki_tpu — a differentiable spectral path tracer in JAX.

A wavefront renderer with the capabilities of the
misaki-render reference (a Mitsuba-2-style C++/Embree spectral path tracer):
same scene description language, same BSDF/emitter/integrator feature set,
same hero-wavelength spectral transport — but redesigned for accelerators:

  * the virtual-dispatch object graph becomes a **scene compiler**
    (XML -> frozen SoA device arrays + static integer tables),
  * Embree becomes our own BVH builder + vectorized wavefront traversal,
  * TBB tile parallelism becomes jit-batched wavefronts on one device and
    `shard_map` over a device mesh across devices,
  * the whole pipeline is differentiable (detached sampling) so pixel
    gradients flow to BSDF/emitter parameters.

Layer map (mirrors SURVEY.md section 1 of the reference):
  core/     L0 math substrate  (spectra, warps, frames, RNG, microfacet)
  scene/    L1+L2 scene description, loading and compilation
  accel/    the Embree replacement (BVH build + traversal)
  bsdf/     L4 material plugins as wavefront kernels
  emitter/  L4 emitter plugins as wavefront kernels
  render/   L3/L5 camera, film, samplers, integrators, render driver
  parallel/ multi-chip sharding (the reference had only TBB threads)
  diff/     differentiable-rendering entry points
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy top-level API so `import misaki_tpu.core.*` works before the
    # higher layers exist / without paying their import cost.
    if name in ("load_file", "load_string"):
        from misaki_tpu.scene import loader

        return getattr(loader, name)
    if name == "render":
        from misaki_tpu.render.driver import render

        return render
    raise AttributeError(name)
