"""The scenes shipped with the repository (`scenes/` at the checkout root),
resolved by name. Their meshes are generated by scene/procedural.py."""

from pathlib import Path

SCENES_DIR = Path(__file__).resolve().parents[2] / "scenes"

SCENES = {
    "cbox": "cbox/scene.xml",
    "bunny": "bunny/scene.xml",
    "teapot-full": "teapot-full/scene.xml",
    "figure2_roughconductor": "figure2_roughconductor.xml",
    "figure3_roughdielectric": "figure3_roughdielectric.xml",
}


def scene_path(name):
    """Path (str) of the shipped scene `name` (a key of SCENES)."""
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; have {sorted(SCENES)}")
    return str(SCENES_DIR / SCENES[name])
