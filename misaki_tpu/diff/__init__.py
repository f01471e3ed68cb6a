"""Differentiable-rendering subsystem: VJP conventions + parameter leaves.

The engine is differentiable end-to-end from a pixel loss to scene
parameters under the **detached-sampling** convention (checked against
finite differences of pixel losses):

  * **Sample placement is detached.** Every sampled quantity that moves a
    ray (BSDF/phase sample directions, distance samples, intersections) is
    wrapped in `stop_gradient` — derivatives flow through *evaluations at
    fixed sample positions*, never through the positions themselves. This
    is the standard detached estimator: unbiased for all integrand
    parameters (reflectance, radiance, sigma, Fresnel eta, microfacet
    alpha) but blind to geometric discontinuities (silhouettes), which
    would need boundary sampling — out of scope per SURVEY.md section 7.
  * **MIS/pdf weights are detached** (`m.mis_power2` results and Russian-
    roulette q are stop-gradient'ed): weights are pdf *ratios* whose
    gradient terms cancel in expectation; detaching them removes variance
    without bias (the "pdf-stopgrad" rule).
  * **Microfacet alpha** participates in gradients only when the scene is
    compiled/flagged with `diff_mode=True` (`scene.replace(diff_mode=True)`
    — `parallel.sharding.train_step_sharded` does this automatically).
    In perf mode alpha stays detached: the attached path re-evaluates the
    full BSDF at the (detached) sampled direction so the weight is
    `f_attached(wo_detached) / pdf_detached` instead of the cancelled
    microfacet short form — correct gradients, ~15% extra bounce cost.
    The raw attached chain through the *sampled direction* is what blew up
    (d wo/d alpha ~ 1/alpha^3 cotangents); detaching wo sidesteps it.

`leaves.py` is the registry of differentiable parameter classes: named
getters/replacers over `CompiledScene` so training loops can request any
subset (packed material columns, emitter radiance sigmoid coeffs + curves,
environment-map texels, homogeneous-medium sigma amplitudes/scales).
"""

from misaki_tpu.diff.leaves import (  # noqa: F401
    DIFF_LEAVES,
    get_leaves,
    leaf_names,
    replace_leaves,
)
