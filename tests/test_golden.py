"""Pixel-level golden-image regression tests (SURVEY.md §4b).

Each ladder fixture (BASELINE.md) (diffuse Cornell, glossy+DoF Cornell,
envmap-NEE demo, nested-dielectric glass box) is rendered at 64^2 and
compared against a committed golden frame (tests/golden/*.npz, produced
by scripts/gen_goldens.py on the same CPU backend these tests run on).

Tolerances are loose enough to survive benign compiler/version float
drift but tight enough that transport regressions — a flipped normal, a
wrong MIS weight, a broken medium stack — shift many pixels and fail.
"""

import pathlib

import numpy as np
import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


def _gen_goldens():
    import sys

    scripts = pathlib.Path(__file__).resolve().parents[1] / "scripts"
    sys.path.insert(0, str(scripts))
    try:
        import gen_goldens
    finally:
        sys.path.remove(str(scripts))
    return gen_goldens


@pytest.fixture(scope="module")
def gen_goldens():
    return _gen_goldens()


@pytest.fixture(scope="module")
def golden_configs(gen_goldens):
    return gen_goldens.configs()


@pytest.mark.parametrize(
    "name", ["cornell_diffuse", "cornell_glossy_dof", "envmap_nee",
             "glass_box", "testing_composite", "testing_active"],
)
@pytest.mark.slow
def test_golden_image(name, gen_goldens, golden_configs):
    import halogen_tpu as ht

    path = GOLDEN_DIR / f"{name}.npz"
    assert path.exists(), (
        f"missing golden {path}; regenerate with "
        "`JAX_PLATFORMS=cpu python scripts/gen_goldens.py`"
    )
    golden = np.load(path)["image"]
    scene, cam, st, frame = golden_configs[name]
    img = np.asarray(ht.render_frame(scene, cam, st, frame), np.float32)

    assert img.shape == golden.shape
    assert np.isfinite(img).all()
    mae_tol, worst_tol = gen_goldens.TOLERANCES.get(
        name, gen_goldens.DEFAULT_TOLERANCE)
    # Mean absolute error across the frame: catches broad shifts.
    mae = np.abs(img - golden).mean()
    assert mae < mae_tol, f"{name}: MAE {mae} vs golden"
    # Worst pixel: catches localized breakage (fireflies, dead regions).
    worst = np.abs(img - golden).max()
    assert worst < worst_tol, f"{name}: max pixel delta {worst} vs golden"


@pytest.mark.slow
def test_testing_scene_inventory():
    """The composite fixture carries the reference Testing Scene's exact
    inventory: 31 spheres + 31 meshes (SURVEY.md §2 asset note), emissive
    intensities up to 10.09, dielectric priorities {0, 1, 2}."""
    import numpy as np

    from halogen_tpu.scene.testing_scene import load_fixture, testing_scene

    fix = load_fixture()
    assert fix["counts"] == {"spheres": 31, "meshes": 31}
    sc = testing_scene(all_groups=True).build()
    assert sc.num_spheres == 31
    em = np.asarray(sc.materials.emissive)
    assert abs(em[:, 3].max() - 10.09) < 1e-4
    prios = set(np.asarray(sc.materials.priority).tolist())
    assert {1, 2} <= prios
    assert sc.any_transmissive
