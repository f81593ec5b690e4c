"""Turntable fly-around through the progressive Renderer (VERDICT r4
item 10): the headless equivalent of the reference's interactive
viewport loop (`HalogenRenderPass.Execute`, HalogenRenderPass.cs:270-357
— re-accumulate while the camera moves, reset on movement).

Orbits the camera around a scene; every stop calls `Renderer.set_camera`
(which fingerprints the camera and resets accumulation, the
camera-moved? branch of Execute :279-291), accumulates `--frames`
progressive frames, and records the image. Emits a horizontal contact
strip PNG and an animated GIF.

Run on a GPU:    python scripts/turntable.py --scene glass_dragon
Artifacts:       renders/turntable_<scene>.png / .gif
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="glass_dragon",
                    choices=["glass_dragon", "dragons_hero", "cornell",
                             "testing_active"])
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--frames", type=int, default=4,
                    help="accumulated frames per view")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import halogen_tpu as ht
    from halogen_tpu.scene import cornell, meshes
    from halogen_tpu.scene.envmap import Envmap

    if args.scene == "glass_dragon":
        scene = meshes.glass_dragon_scene().build(
            envmap=Envmap.gradient_sky())
        center, r, h, fov = (0.0, -0.3, 0.0), 4.5, 1.3, 45
        st_extra = dict(max_bounces=8, use_envmap=True)
    elif args.scene == "dragons_hero":
        scene = meshes.dragons_hero_scene().build(
            envmap=Envmap.gradient_sky())
        center, r, h, fov = (0.0, -0.2, 0.0), 5.0, 1.6, 45
        st_extra = dict(max_bounces=6, use_envmap=True)
    elif args.scene == "testing_active":
        from halogen_tpu.scene.testing_scene import testing_scene

        scene = testing_scene(all_groups=False).build(
            envmap=Envmap.gradient_sky())
        center, r, h, fov = (3.48, 1.2, 17.55), 4.5, 1.8, 60
        st_extra = dict(max_bounces=5, use_envmap=True)
    else:
        scene = cornell.cornell_box(glossy=True).build()
        center, r, h, fov = (0.0, 0.0, 0.0), 3.2, 0.0, 40
        st_extra = dict(max_bounces=6)

    st = ht.RenderSettings(
        width=args.width, height=args.width,
        samples_per_pixel=args.spp,
        max_accumulated_frames=args.frames, unlimited_sampling=False,
        **st_extra)

    def cam_at(angle):
        pos = (center[0] + r * np.sin(angle), center[1] + h,
               center[2] + r * np.cos(angle))
        return ht.make_camera(position=pos, target=center, fov_deg=fov)

    renderer = ht.Renderer(scene, cam_at(0.0), st)
    views = []
    for i in range(args.views):
        # set_camera fingerprints the pose; a changed pose resets
        # FrameCount to 1 exactly like the reference's camera-moved path
        renderer.set_camera(cam_at(2 * np.pi * i / args.views))
        assert renderer.state.frame_count == (1 if i == 0 else 1)
        img = renderer.render()  # accumulates to max_accumulated_frames
        assert renderer.done
        views.append(np.asarray(img))
        print(f"view {i + 1}/{args.views}: mean={views[-1].mean():.4f}",
              flush=True)

    def to8(img):
        return (np.clip(img, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8)[
            ::-1]

    strip = np.concatenate([to8(v) for v in views], axis=1)
    out = args.out or f"renders/turntable_{args.scene}"
    pathlib.Path(out).parent.mkdir(exist_ok=True)
    try:
        from PIL import Image

        Image.fromarray(strip).save(out + ".png")
        frames = [Image.fromarray(to8(v)) for v in views]
        frames[0].save(out + ".gif", save_all=True,
                       append_images=frames[1:], duration=150, loop=0)
        print(f"wrote {out}.png ({strip.shape[1]}x{strip.shape[0]}) "
              f"and {out}.gif on {jax.default_backend()}")
    except ImportError:
        np.savez_compressed(out + ".npz", strip=strip)
        print(f"wrote {out}.npz (PIL unavailable)")


if __name__ == "__main__":
    main()
