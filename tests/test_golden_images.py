"""Golden-image parity tests ("image parity with teeth").

Each committed golden (tests/goldens/*.npz, generated by
tools/gen_goldens.py on the CPU backend at a fixed seed from the shipped
scenes) is re-rendered with identical settings and compared:

  * texel-level: the render is deterministic per (platform, seed), so the
    bulk of texels must match tightly — only XLA version-to-version fusion
    drift is tolerated;
  * statistics: mean image error must be tiny — a regression in any
    material / emitter / sampling / film stage moves many texels at once.
"""

import os

import numpy as np
import pytest

from tools.gen_goldens import GOLDENS, render_golden

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_image(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden {name} not generated (tools/gen_goldens.py)")
    want = np.load(path)["rgb"]
    got = render_golden(name)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-3)
    err = np.abs(got - want) / scale
    # bulk must be essentially identical (same platform, same seed)
    frac_off = float((err > 1e-3).mean())
    assert frac_off < 0.02, f"{name}: {frac_off:.2%} texels differ"
    assert float(err.mean()) < 1e-3, f"{name}: mean rel err {err.mean():.2e}"
