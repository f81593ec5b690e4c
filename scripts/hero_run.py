"""BASELINE ladder config 5 end-to-end: the dragons hero scene at 4096
accumulated spp, rendered through the SHARDED path, plus one sharded
inverse-rendering gradient step. Writes perf/hero_run.json (one JSON line
per run, naming the backend) and renders/hero.png.

The scene uses the reference's real Dragon_8k geometry (three instances,
mixed materials) under the gradient sky. Rendering goes through
`parallel.sharding.render_frame_sharded` over a ("px","spp") mesh —
over every GPU of the host (1x1 on one card, exercising the same
shard_map program four cards run), or the 8-device virtual CPU mesh with
`--small` for the multi-device proof. The gradient step runs `diff.grad.fit_materials`
with `mesh=` (the unified optax+projection trainer, psum'd grads).

Usage:
    python scripts/hero_run.py                    # GPU, full hero config
    python scripts/hero_run.py --small            # CPU 8-dev mesh, tiny
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="8-virtual-device CPU mesh at tiny shapes")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--spp-per-frame", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    args = ap.parse_args()

    if args.small:
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import numpy as np
    import jax.numpy as jnp
    import halogen_tpu as ht
    from halogen_tpu.diff.grad import fit_materials
    from halogen_tpu.parallel.sharding import (
        make_render_mesh,
        render_frame_sharded,
    )
    from halogen_tpu.scene.envmap import Envmap
    from halogen_tpu.scene.meshes import dragons_hero_scene

    n_dev = len(jax.devices())
    if args.small:
        width = args.width or 64
        spp_frame = args.spp_per_frame or 8
        frames = args.frames or 2
        mesh = make_render_mesh(n_dev // 2, 2)
    else:
        width = args.width or 512
        spp_frame = args.spp_per_frame or 64
        frames = args.frames or 64  # 64 x 64spp = 4096 accumulated spp
        mesh = make_render_mesh(n_dev, 1)

    scene = dragons_hero_scene().build(envmap=Envmap.gradient_sky())
    cam = ht.make_camera(position=(0, 1.5, 5.0), target=(0, -0.3, 0),
                         fov_deg=45)
    st = ht.RenderSettings(
        width=width, height=width, samples_per_pixel=spp_frame,
        max_bounces=8, use_envmap=True,
        ray_chunk_size=min(width * width, 262144),
    )

    # progressive accumulation across frames (EMA weight 1/N — the
    # reference's AccumulationShader semantics)
    t0 = time.perf_counter()
    acc = None
    for f in range(frames):
        img = render_frame_sharded(scene, cam, st, jnp.uint32(f + 1), mesh)
        acc = img if acc is None else acc + (img - acc) / (f + 1)
    acc.block_until_ready()
    dt = time.perf_counter() - t0
    total_spp = spp_frame * frames
    mrays = total_spp * width * width / dt / 1e6

    out_dir = pathlib.Path("renders")
    out_dir.mkdir(exist_ok=True)
    acc_np = np.asarray(acc)
    try:
        from PIL import Image

        im8 = (np.clip(acc_np, 0.0, 1.0) ** (1 / 2.2) * 255).astype(np.uint8)
        Image.fromarray(im8[::-1]).save(out_dir / "hero.png")
    except ImportError:
        np.savez_compressed(out_dir / "hero.npz", image=acc_np)

    # one sharded inverse-rendering gradient step against the render,
    # at a reduced size to keep the step short (the backward replays
    # every bounce's BVH walk).
    fit_w = min(width, 128)
    fit_st = st.replace(width=fit_w, height=fit_w,
                        samples_per_pixel=max(spp_frame // 8, 2),
                        ray_chunk_size=fit_w * fit_w)
    tgt_small = jnp.asarray(acc_np[::width // fit_w, ::width // fit_w])
    _, losses = fit_materials(
        scene, cam, fit_st, tgt_small, steps=1, lr=1e-2,
        mesh=mesh,
    )

    rec = {
        "key": "hero_dragons_4096spp" if not args.small else "hero_small",
        "backend": jax.default_backend(),
        "devices": n_dev,
        "mesh": dict(mesh.shape),
        "width": width,
        "total_spp": total_spp,
        "frames": frames,
        "bounces": st.max_bounces,
        "tris": scene.num_triangles,
        "render_s": round(dt, 1),
        "mrays_per_s": round(mrays, 2),
        "mean_radiance": round(float(acc_np.mean()), 4),
        "finite": bool(np.isfinite(acc_np).all()),
        "grad_step_loss": round(float(losses[0]), 6),
        "ts": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    pathlib.Path("perf").mkdir(exist_ok=True)
    with open("perf/hero_run.json", "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
