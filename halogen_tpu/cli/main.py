"""Command-line renderer: the headless equivalent of the reference's Unity
editor loop (scene + settings -> progressive render -> image on disk), plus
the benchmark-ladder configs (BASELINE.md) as named presets.

Usage:
    python -m halogen_tpu.cli render --preset cornell_256 --out out.png
    python -m halogen_tpu.cli render --scene cornell --width 512 --spp 16
    python -m halogen_tpu.cli bench --preset cornell_glossy_512
    python -m halogen_tpu.cli fit --steps 50 --out fitted.png
    python -m halogen_tpu.cli debug-sobol --out sobol.png
"""

from __future__ import annotations

import argparse
import json
import sys
import time


# ---------------------------------------------------------------------------
# Ladder presets (BASELINE.md)
# ---------------------------------------------------------------------------

PRESETS = {
    # 1. Cornell box, diffuse-only, 256x256, 4spp, 2 bounces (CPU-runnable)
    "cornell_256": dict(scene="cornell", width=256, spp=4, bounces=2,
                        frames=1),
    # 2. Cornell + glossy/emissive, focal blur, 512x512, 64spp
    "cornell_glossy_512": dict(scene="cornell_glossy", width=512, spp=64,
                               bounces=6, frames=1, aperture=2.0),
    # 3. Envmap scene with importance sampling + Blackman-Harris AA, 1024^2
    "envmap_1024": dict(scene="envmap_demo", width=1024, spp=16, bounces=4,
                        frames=1, envmap=True, env_nee=True),
    # 4. Glass dragon: nested dielectrics + absorption + RR
    "glass_dragon": dict(scene="glass_dragon", width=512, spp=32, bounces=12,
                         frames=1),
    # 5. Dragons hero scene, 4096spp (sharded; gradient step via `fit`)
    "dragons_hero": dict(scene="dragons", width=512, spp=64, bounces=8,
                         frames=64, sharded=True),
}


def _build_scene(name: str, use_envmap: bool):
    from halogen_tpu.scene import cornell
    from halogen_tpu.scene.envmap import Envmap
    from halogen_tpu.scene import meshes

    env = Envmap.gradient_sky() if use_envmap else None
    if name == "cornell":
        return cornell.cornell_box().build(envmap=env)
    if name == "cornell_glossy":
        return cornell.cornell_box(glossy=True).build(envmap=env)
    if name == "material_demo":
        return cornell.material_demo_spheres().build(
            envmap=env or Envmap.gradient_sky())
    if name == "envmap_demo":
        return cornell.material_demo_spheres().build(
            envmap=env or Envmap.gradient_sky())
    if name == "glass_sphere_box":
        return cornell.glass_sphere_box().build(envmap=env)
    if name == "glass_dragon":
        return meshes.glass_dragon_scene().build(envmap=env)
    if name == "dragons":
        return meshes.dragons_hero_scene().build(
            envmap=env or Envmap.gradient_sky())
    raise SystemExit(f"unknown scene {name!r}; options: cornell, "
                     "cornell_glossy, material_demo, envmap_demo, "
                     "glass_sphere_box, glass_dragon, dragons")


def _camera(args):
    import halogen_tpu as ht
    return ht.make_camera(
        position=tuple(args.cam_pos), target=tuple(args.cam_target),
        fov_deg=args.fov, aperture_deg=args.aperture,
        focal_distance=args.focal_distance,
    )


def _settings(args):
    import halogen_tpu as ht
    from halogen_tpu.config import SamplerKind
    return ht.RenderSettings(
        width=args.width, height=args.height or args.width,
        samples_per_pixel=args.spp, max_bounces=args.bounces,
        max_accumulated_frames=args.frames,
        unlimited_sampling=False,
        use_envmap=args.envmap,
        env_importance_sampling=args.env_nee,
        light_importance_sampling=args.light_nee,
        wavefront=args.wavefront,
        env_mip_level=0 if args.env_nee else 1,
        sampler=SamplerKind.PRNG if args.prng else SamplerKind.SOBOL,
        russian_roulette=not args.no_rr,
        ray_chunk_size=args.chunk,
    )


def _save_png(img, path: str, gamma: float = 2.2, flip: bool = True):
    """Write a PNG through PIL, the CLI's only use of it. Without PIL the
    linear float image goes to `<path>.npy` instead, and a warning says
    so: rendering itself never needs PIL."""
    import numpy as np
    from halogen_tpu.utils.metrics import get_logger

    img = np.asarray(img)
    im8 = (np.clip(img, 0.0, 1.0) ** (1.0 / gamma) * 255).astype(np.uint8)
    if flip:
        im8 = im8[::-1]  # row 0 is the bottom of the frame
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", img)
        get_logger().warning(
            "PIL is not installed, so no PNG was written: saved the linear "
            "image to %s.npy instead", path)
        return
    Image.fromarray(im8).save(path)


def _add_render_args(p: argparse.ArgumentParser):
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--scene", default="cornell")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--bounces", type=int, default=6)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--envmap", action="store_true")
    p.add_argument("--env-nee", dest="env_nee", action="store_true",
                   help="envmap importance sampling (NEE + MIS)")
    p.add_argument("--light-nee", dest="light_nee", action="store_true",
                   help="area-light importance sampling (NEE + MIS)")
    p.add_argument("--wavefront", action="store_true",
                   help="wavefront scheduler (compact + live blocks)")
    p.add_argument("--prng", action="store_true",
                   help="PCG PRNG sampler ablation")
    p.add_argument("--no-rr", action="store_true",
                   help="disable Russian roulette")
    p.add_argument("--sharded", action="store_true",
                   help="shard over all local devices")
    p.add_argument("--chunk", type=int, default=262144)
    p.add_argument("--fov", type=float, default=40.0)
    p.add_argument("--aperture", type=float, default=0.0)
    p.add_argument("--focal-distance", type=float, default=None)
    p.add_argument("--cam-pos", type=float, nargs=3, default=[0.0, 0.0, 3.2])
    p.add_argument("--cam-target", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--out", default="render.png")
    p.add_argument("--checkpoint", default=None,
                   help="save/resume accumulation state (npz)")


def _apply_preset(args):
    if not args.preset:
        return args
    for k, v in PRESETS[args.preset].items():
        setattr(args, k, v)
    return args


def cmd_render(args) -> int:
    import os
    import halogen_tpu as ht
    from halogen_tpu.utils.metrics import RaysMeter, RenderStats, get_logger

    args = _apply_preset(args)
    log = get_logger()
    scene = _build_scene(args.scene, args.envmap)
    cam = _camera(args)
    st = _settings(args)

    if args.sharded:
        import jax
        from halogen_tpu.parallel.sharding import (
            make_render_mesh, render_frame_sharded)
        mesh = make_render_mesh()
        log.info("sharded over %s mesh %s", len(jax.devices()), mesh.shape)
        import numpy as np
        acc = None
        meter = RaysMeter()
        for f in range(args.frames):
            t0 = time.perf_counter()
            img = render_frame_sharded(scene, cam, st, f + 1, mesh)
            img.block_until_ready()
            dt = time.perf_counter() - t0
            meter.add(st.samples_per_pixel * st.num_pixels)
            acc = img if acc is None else acc + (img - acc) / (f + 1)
            RenderStats(f + 1, st.width, st.height, st.samples_per_pixel,
                        dt).log(log)
        _save_png(acc, args.out)
    else:
        r = ht.Renderer(scene, cam, st)
        if args.checkpoint and os.path.exists(args.checkpoint):
            r.load_checkpoint(args.checkpoint)
            log.info("resumed at frame %d", int(r.state.frame_count))
        meter = RaysMeter()
        while not r.done:
            t0 = time.perf_counter()
            r.step()
            dt = time.perf_counter() - t0
            meter.add(st.samples_per_pixel * st.num_pixels)
            RenderStats(int(r.state.frame_count) - 1, st.width, st.height,
                        st.samples_per_pixel, dt).log(log)
        if args.checkpoint:
            r.save_checkpoint(args.checkpoint)
        _save_png(r.image, args.out)
    log.info("wrote %s (%.1f Mrays/s trailing)", args.out,
             meter.mrays_per_sec)
    return 0


def cmd_bench(args) -> int:
    import jax.numpy as jnp
    from halogen_tpu.integrator.trace import render_frame
    from halogen_tpu.utils.device import device_info

    args = _apply_preset(args)
    scene = _build_scene(args.scene, args.envmap)
    cam = _camera(args)
    st = _settings(args)
    render_frame(scene, cam, st, jnp.uint32(0)).block_until_ready()
    t0 = time.perf_counter()
    for f in range(max(args.frames, 1)):
        img = render_frame(scene, cam, st, jnp.uint32(f + 1))
    img.block_until_ready()
    dt = time.perf_counter() - t0
    rays = st.samples_per_pixel * st.num_pixels * max(args.frames, 1)
    print(json.dumps({
        "metric": f"fwd_throughput_{args.preset or args.scene}",
        "value": rays / dt / 1e6,
        "unit": "Mrays/s/chip",
        "device": device_info(),
    }))
    return 0


def cmd_fit(args) -> int:
    """Inverse-rendering demo: perturb materials, then recover them."""
    import numpy as np
    import jax.numpy as jnp
    import halogen_tpu as ht
    from halogen_tpu.diff.grad import fit_materials
    from halogen_tpu.utils.metrics import get_logger

    args = _apply_preset(args)
    log = get_logger()
    scene = _build_scene(args.scene, args.envmap)
    cam = _camera(args)
    st = _settings(args)

    target = ht.render_frame(scene, cam, st, 0)
    # perturb the albedos and refit
    import dataclasses
    mats = scene.materials
    perturbed = dataclasses.replace(
        mats, albedo=jnp.clip(mats.albedo * 0.5 + 0.2, 0, 1))
    scene_p = dataclasses.replace(scene, materials=perturbed)
    params, losses = fit_materials(scene_p, cam, st, target,
                                   steps=args.steps, lr=args.lr)
    log.info("fit: loss %.3g -> %.3g over %d steps", losses[0], losses[-1],
             len(losses))
    final = ht.render_frame(
        dataclasses.replace(scene, materials=params["materials"]),
        cam, st, 0)
    _save_png(final, args.out)
    print(json.dumps({"initial_loss": losses[0], "final_loss": losses[-1]}))
    return 0


def cmd_debug_sobol(args) -> int:
    """Sampler/filter visualizer (DebugSobol.compute, SURVEY.md §2 #5)."""
    from halogen_tpu.sampler.debug import sobol_filter_image
    img = sobol_filter_image(size=args.width, count=args.count)
    _save_png(img, args.out, gamma=1.0, flip=False)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="halogen_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="progressive render to PNG")
    _add_render_args(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="timed forward throughput (JSON line)")
    _add_render_args(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("fit", help="inverse-rendering material fit demo")
    _add_render_args(p)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=5e-2)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("debug-sobol", help="sampler distribution visualizer")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--count", type=int, default=100_000)
    p.add_argument("--out", default="sobol.png")
    p.set_defaults(fn=cmd_debug_sobol)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
