"""Regenerate the pixel-level golden images used by tests/test_golden.py.

Run on the CPU backend (the test backend, tests/conftest.py) so goldens
and test renders go through the same compiler:

    JAX_PLATFORMS=cpu python scripts/gen_goldens.py

`configs()` and `TOLERANCES` are imported by tests/test_golden.py and by
chip_smoke.py (which holds GPU renders to the same bounds), so importing
this module selects no backend.

Goldens are small float32 frames of the ladder fixtures (BASELINE.md;
SURVEY.md §4b: "golden-image integration tests on the ladder configs").
They are committed to tests/golden/ and compared with a loose tolerance
so benign cross-version float drift does not trip them while real
transport regressions (sign flips, wrong walls, broken NEE) do.
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import halogen_tpu as ht  # noqa: E402

# (mae, worst-pixel) tolerance of a render against its golden. The
# testing_composite fixture contains the reference's giant
# transparent/emissive OutdoorsScene spheres that enclose the whole world
# — single-path fireflies there can exceed 10, so a 1-ulp compiler drift
# that reroutes one path moves one pixel by O(emission); the MAE bound
# still catches real transport regressions (which shift many pixels), the
# worst-pixel bound is relaxed.
DEFAULT_TOLERANCE = (5e-3, 0.15)
TOLERANCES = {
    "testing_composite": (2e-2, 16.0),
    "testing_active": (5e-3, 1.0),
}


def configs():
    """Name -> (scene, camera, settings, frame). Kept in one place so the
    test imports it and cannot drift from the generator."""
    from halogen_tpu.scene import cornell
    from halogen_tpu.scene.envmap import Envmap

    cam = ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
    out = {}

    # Ladder 1: diffuse Cornell (64^2 stand-in for the 256^2 config).
    out["cornell_diffuse"] = (
        cornell.cornell_box().build(),
        cam,
        ht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                          max_bounces=2, ray_chunk_size=4096),
        1,
    )

    # Ladder 2: glossy/emissive Cornell with focal blur.
    out["cornell_glossy_dof"] = (
        cornell.cornell_box(glossy=True).build(),
        ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40,
                       aperture_deg=2.0, focal_distance=3.2),
        ht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                          max_bounces=4, ray_chunk_size=4096),
        1,
    )

    # Ladder 3: envmap NEE + Blackman-Harris AA.
    out["envmap_nee"] = (
        cornell.material_demo_spheres().build(envmap=Envmap.gradient_sky()),
        ht.make_camera(position=(0, 1.0, 6.0), target=(0, 0.5, 0),
                       fov_deg=40),
        ht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                          max_bounces=4, use_envmap=True,
                          env_importance_sampling=True,
                          ray_chunk_size=4096),
        1,
    )

    # Ladder 4: nested dielectrics + absorption + RR (glass sphere box).
    out["glass_box"] = (
        cornell.glass_sphere_box().build(),
        cam,
        ht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                          max_bounces=8, max_transmission_bounces=8,
                          ray_chunk_size=4096),
        1,
    )

    # The reference's Testing Scene (scene/testing_scene.py): the
    # everything-at-once composite (all 62 objects, exact transforms/
    # materials/priorities from Testing Scene.unity) viewed into its
    # Cornell group, and the shipped active set through the scene's own
    # Main Camera. The composite includes the OutdoorsScene's giant
    # transparent/emissive spheres that enclose the world — heavy
    # variance by construction, so its golden uses a looser worst-pixel
    # tolerance (see test_golden.py TOLS).
    from halogen_tpu.scene.testing_scene import (
        testing_scene, testing_scene_camera)

    out["testing_composite"] = (
        testing_scene(all_groups=True).build(
            envmap=Envmap.gradient_sky()),
        ht.make_camera(position=(3.48, 1.8, 12.2),
                       target=(3.48, 1.0, 17.55),
                       fov_deg=60, near=0.6, far=1000),
        ht.RenderSettings(width=128, height=128, samples_per_pixel=4,
                          max_bounces=5, use_envmap=True,
                          ray_chunk_size=16384),
        1,
    )
    out["testing_active"] = (
        testing_scene(all_groups=False).build(
            envmap=Envmap.gradient_sky()),
        testing_scene_camera(),
        ht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                          max_bounces=4, use_envmap=True,
                          ray_chunk_size=4096),
        1,
    )
    return out


def main():
    golden_dir = pathlib.Path(__file__).resolve().parents[1] / "tests" / "golden"
    golden_dir.mkdir(exist_ok=True)
    for name, (scene, cam, st, frame) in configs().items():
        img = np.asarray(ht.render_frame(scene, cam, st, frame), np.float32)
        assert np.isfinite(img).all(), name
        np.savez_compressed(golden_dir / f"{name}.npz", image=img)
        print(f"{name}: shape={img.shape} mean={img.mean():.4f} "
              f"max={img.max():.3f}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
