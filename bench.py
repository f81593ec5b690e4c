"""Throughput benchmark: Mrays/s on the flagship Cornell scene.

Reproduces the reference's only performance metric — the MRays/s HUD
(`HalogenRenderFeature.cs:97`, `HalogenDebugUI.cs:59-76`: rays per frame =
SPP * W * H, i.e. primary rays dispatched) — as a timed harness on an
NVIDIA GPU:

    python bench.py            # full configurations; GPU only
    python bench.py --quick    # small configurations, any device

Every JSON line names the device it ran on (platform, device kind, device
count, and the card's name and power limit). Without --quick the script
refuses to run off the GPU: a CPU time is not a device number.

The forward JSON line is printed and flushed the moment the forward loop
finishes; the fwd+bwd and glass_dragon sections then run under an internal
time budget (BENCH_TIME_BUDGET seconds, default 480) enforced with
SIGALRM, each printing an enriched line with the same schema. The
persistent compilation cache lives where `utils/compile_cache.py` says.
"""

import argparse
import json
import os
import signal
import sys
import time


class _BudgetExceeded(Exception):
    pass


def _emit(mrays, device, extra):
    print(json.dumps({
        "metric": "fwd_throughput_cornell",
        "value": mrays,
        "unit": "Mrays/s/chip",
        "device": device,
        "extra": extra,
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small config for smoke testing")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--bounces", type=int, default=None)
    ap.add_argument("--budget", type=float,
                    default=float(os.environ.get("BENCH_TIME_BUDGET", 480)))
    args = ap.parse_args()
    t_start = time.monotonic()

    import jax
    import jax.numpy as jnp
    import halogen_tpu as ht
    from halogen_tpu.integrator.trace import render_frame
    from halogen_tpu.scene import cornell
    from halogen_tpu.utils.compile_cache import enable_compile_cache
    from halogen_tpu.utils.device import card_name_and_power_limit, \
        device_info

    device = device_info()
    if device["platform"] != "gpu" and not args.quick:
        print(f"bench.py: JAX's device is {device['platform']!r}, not a "
              "GPU; pass --quick for a small run that times this device",
              file=sys.stderr)
        return 2
    device["card"] = (card_name_and_power_limit()
                      if device["platform"] == "gpu" else None)
    enable_compile_cache()

    if args.quick:
        width = args.width or 128
        spp = args.spp or 4
        frames = args.frames or 2
        bounces = args.bounces if args.bounces is not None else 4
    else:
        width = args.width or 512
        spp = args.spp or 32
        frames = args.frames or 4
        bounces = args.bounces if args.bounces is not None else 6

    scene = cornell.cornell_box(glossy=True).build()
    camera = ht.make_camera(position=(0.0, 0.0, 3.2), target=(0.0, 0.0, 0.0),
                            fov_deg=40.0)
    settings = ht.RenderSettings(
        width=width, height=width, samples_per_pixel=spp,
        max_bounces=bounces,
        ray_chunk_size=min(width * width, 262144),
    )

    # Warm-up / compile
    render_frame(scene, camera, settings, jnp.uint32(0)).block_until_ready()

    t0 = time.perf_counter()
    for f in range(frames):
        img = render_frame(scene, camera, settings, jnp.uint32(f + 1))
    img.block_until_ready()
    dt = time.perf_counter() - t0

    rays = spp * width * width * frames  # HUD definition: primary rays
    mrays = rays / dt / 1e6

    # FIRST line: the official artifact, emitted before anything slow.
    extras = {"config": f"{width}x{width}, {spp}spp, {bounces} bounces",
              "fwd_bwd_throughput_cornell_256spp": None,
              "fwd_bwd_status": "pending",
              "glass_dragon_mrays": None,
              "glass_dragon_status": "pending"}
    _emit(mrays, device, dict(extras))

    # --- fwd+bwd: Mrays/s/chip (fwd+bwd) at 256 spp on the Cornell box —
    # one render_loss_grad step (forward render +
    # path-replay backward) timed per effective primary ray. Runs under
    # the remaining time budget; on SIGALRM the fwd line above stands.
    remaining = args.budget - (time.monotonic() - t_start)
    if remaining < 20:
        extras["fwd_bwd_status"] = "skipped_budget"
        extras["glass_dragon_status"] = "skipped_budget"
        _emit(mrays, device, dict(extras))
        return 0

    def _on_alarm(signum, frame):
        raise _BudgetExceeded()

    old = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(max(1, int(remaining)))
    try:
        from halogen_tpu.diff.grad import render_loss_grad

        if args.quick:
            bwd_w, bwd_spp = 64, 4
        else:
            bwd_w, bwd_spp = 256, 256
        bwd_settings = ht.RenderSettings(
            width=bwd_w, height=bwd_w, samples_per_pixel=bwd_spp,
            max_bounces=bounces, ray_chunk_size=min(bwd_w * bwd_w, 262144),
        )
        params = {"materials": scene.materials}
        target = jnp.zeros((bwd_w, bwd_w, 3), jnp.float32)
        loss, grads = render_loss_grad(
            params, scene, camera, bwd_settings, target, jnp.uint32(0))
        jax.block_until_ready((loss, grads))  # compile + warm-up
        bwd_frames = 1 if args.quick else 2
        t0 = time.perf_counter()
        for f in range(bwd_frames):
            loss, grads = render_loss_grad(
                params, scene, camera, bwd_settings, target, jnp.uint32(f + 1))
        jax.block_until_ready((loss, grads))
        dt_bwd = time.perf_counter() - t0
        mrays_bwd = bwd_spp * bwd_w * bwd_w * bwd_frames / dt_bwd / 1e6
        signal.alarm(0)
        extras.update({
            "fwd_bwd_throughput_cornell_256spp": mrays_bwd,
            "fwd_bwd_unit": "Mrays/s/chip (fwd+bwd)",
            "fwd_bwd_config": f"{bwd_w}x{bwd_w}, {bwd_spp}spp, "
                              f"{bounces} bounces",
            "fwd_bwd_status": "ok",
        })
        _emit(mrays, device, dict(extras))
    except _BudgetExceeded:
        extras["fwd_bwd_status"] = "timeout_budget"
        _emit(mrays, device, dict(extras))
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)

    # --- big-scene frontier metric (round-3 verdict weak #7: the
    # official bench must track the ladder-4 scene, not just Cornell).
    # Budget-guarded exactly like the fwd+bwd stage.
    remaining = args.budget - (time.monotonic() - t_start)
    if remaining < 20:
        extras["glass_dragon_status"] = "skipped_budget"
        _emit(mrays, device, dict(extras))
        return 0
    old2 = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(max(1, int(remaining)))
    try:
        from halogen_tpu.scene import meshes

        if args.quick:
            gw, gspp, gb, gframes = 64, 2, 4, 1
        else:
            gw, gspp, gb, gframes = 512, 32, 12, 1
        gscene = meshes.glass_dragon_scene().build()
        gcam = ht.make_camera(position=(0, 1.5, 5.0), target=(0, -0.3, 0),
                              fov_deg=45)
        gsettings = ht.RenderSettings(
            width=gw, height=gw, samples_per_pixel=gspp, max_bounces=gb,
            ray_chunk_size=min(gw * gw, 262144),
        )
        render_frame(gscene, gcam, gsettings,
                     jnp.uint32(0)).block_until_ready()
        t0 = time.perf_counter()
        for f in range(gframes):
            gimg = render_frame(gscene, gcam, gsettings, jnp.uint32(f + 1))
        gimg.block_until_ready()
        g_mrays = gspp * gw * gw * gframes / (time.perf_counter() - t0) / 1e6
        signal.alarm(0)
        extras.update({
            "glass_dragon_mrays": g_mrays,
            "glass_dragon_config": f"{gw}x{gw}, {gspp}spp, {gb} bounces",
            "glass_dragon_status": "ok",
        })
        _emit(mrays, device, dict(extras))
    except _BudgetExceeded:
        extras["glass_dragon_status"] = "timeout_budget"
        _emit(mrays, device, dict(extras))
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
