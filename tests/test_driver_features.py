"""Driver-level feature tests: checkpoint/resume (SURVEY.md section 5 —
preemption recovery), progress reporting, and render determinism across
chunk interruption."""

import numpy as np
import pytest

from misaki_tpu.render import driver
from misaki_tpu.scene.compiler import load_and_compile
from misaki_tpu.scene.assets import scene_path

CBOX = scene_path("cbox")


@pytest.fixture(scope="module")
def scene():
    return load_and_compile(CBOX, spp=4, width=32, height=24)


def test_checkpoint_resume_bit_identical(scene, tmp_path):
    """Kill the render mid-way (simulated via an exception from the progress
    callback), resume from the snapshot, and compare against the
    uninterrupted image — must be IDENTICAL (chunk order and per-lane RNG
    are deterministic)."""
    chunk_size = 32 * 4 * 6  # 6 pixel rows per chunk -> 4 chunks
    ref = driver.render(scene, seed=3, chunk_size=chunk_size, depth_cap=3)
    ref_rgb = np.asarray(ref["rgb"])

    ck = str(tmp_path / "film.ckpt.npz")

    class Killed(RuntimeError):
        pass

    def killer(done, total):
        if done == 2:
            raise Killed()

    with pytest.raises(Killed):
        driver.render(scene, seed=3, chunk_size=chunk_size, depth_cap=3,
                      checkpoint_path=ck, checkpoint_every=1,
                      progress=killer)

    import os
    assert os.path.exists(ck), "snapshot must survive the crash"
    out = driver.render(scene, seed=3, chunk_size=chunk_size, depth_cap=3,
                        checkpoint_path=ck, checkpoint_every=1)
    np.testing.assert_array_equal(np.asarray(out["rgb"]), ref_rgb)
    assert not os.path.exists(ck), "completed render must clear the snapshot"


def test_checkpoint_rejects_mismatched_render(scene, tmp_path):
    from misaki_tpu.render import film as film_mod

    ck = str(tmp_path / "film.ckpt.npz")
    chunk = driver.pick_chunk(driver.DEFAULT_CHUNK, scene.spp,
                              scene.film_width * scene.film_height * scene.spp)
    fp = driver._scene_fingerprint(scene, 3, 3, chunk)
    film = film_mod.new_film_flat(scene.film_height, scene.film_width, 5,
                                  scene.filter_type, scene.filter_stddev)
    driver.save_checkpoint(ck, film, 2, fp)
    # different seed -> fingerprint mismatch -> ignored (fresh render)
    assert driver.load_checkpoint(
        ck, driver._scene_fingerprint(scene, 4, 3, chunk)) is None
    # matching fingerprint -> accepted
    got = driver.load_checkpoint(ck, fp)
    assert got is not None and got[1] == 2


def test_progress_callback_sees_every_chunk(scene):
    chunk_size = 32 * 4 * 6
    seen = []
    driver.render(scene, seed=0, chunk_size=chunk_size, depth_cap=2,
                  progress=lambda done, total: seen.append((done, total)))
    assert seen, "multi-chunk renders must report progress"
    total = seen[0][1]
    assert [d for d, _ in seen] == list(range(1, total + 1))
