"""Variance benchmark: NEE+MIS convergence win at equal spp.

Measures the error of K independent equal-spp frames against a high-spp
reference, with next-event estimation on vs off, on the two
glossy-dominant ladder scenes (cornell glossy -> area-light NEE;
material demo + sky -> envmap NEE). Since round 2 the NEE coverage
includes the reference's procedural glossy lobe via its closed-form pdf
(core.math.procedural_glossy_pdf), so the win now shows on glossy
pixels, not just diffuse ones.

Writes one JSON line per config to perf/variance.jsonl. CPU-runnable.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    import jax
    import numpy as np
    import jax.numpy as jnp
    import halogen_tpu as ht
    from halogen_tpu.scene import cornell
    from halogen_tpu.scene.envmap import Envmap

    out_path = pathlib.Path("perf/variance.jsonl")
    out_path.parent.mkdir(exist_ok=True)

    cam_c = ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0),
                           fov_deg=40)
    cam_m = ht.make_camera(position=(0, 2.0, 6.0), target=(0, 0, -1),
                           fov_deg=45)
    configs = {
        "cornell_glossy_lightnee": (
            cornell.cornell_box(glossy=True).build(),
            cam_c,
            dict(light_importance_sampling=True),
        ),
        "material_demo_envnee": (
            cornell.material_demo_spheres().build(
                envmap=Envmap.gradient_sky()),
            cam_m,
            dict(use_envmap=True, env_importance_sampling=True,
                 env_mip_level=0),
        ),
    }

    w, spp, frames = 48, 8, 6
    base = ht.RenderSettings(width=w, height=w, samples_per_pixel=spp,
                             max_bounces=4, ray_chunk_size=w * w)

    for name, (scene, cam, nee_kw) in configs.items():
        # high-spp reference (NEE on — both estimators are unbiased, the
        # lower-variance one makes the better truth)
        ref_st = base.replace(samples_per_pixel=256, **nee_kw)
        ref = np.asarray(ht.render_frame(scene, cam, ref_st, jnp.uint32(0)))

        rec = {"key": name, "width": w, "spp": spp, "frames": frames,
               "backend": jax.default_backend(),
               "ts": time.strftime("%Y-%m-%d %H:%M:%S")}
        for tag, kw in (("nee_on", nee_kw), ("nee_off", {})):
            st = base.replace(**kw)
            mses = []
            for f in range(frames):
                img = np.asarray(
                    ht.render_frame(scene, cam, st, jnp.uint32(f + 1)))
                mses.append(float(np.mean((img - ref) ** 2)))
            rec[f"mse_{tag}"] = round(float(np.mean(mses)), 6)
        rec["variance_reduction_x"] = round(
            rec["mse_nee_off"] / max(rec["mse_nee_on"], 1e-12), 2)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
