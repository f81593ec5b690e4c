"""Smoke test of the path tracer on one NVIDIA GPU, through the entry
points a user calls, at the full width of the repo's configurations.

    python chip_smoke.py          # one card: phases device .. timing
    python chip_smoke.py --four   # four cards: the sharded phase only

Phases (one card):

1. device   - JAX's default device must be a GPU; prints its kind and the
              card's name and power limit. Exits non-zero otherwise.
2. forward  - renders each configuration of CONFIGS at full width on the
              GPU (`Renderer.render` for the first, `render_frame` for
              the rest) and checks every pixel is finite; then renders a
              fixed set of 4,096 pixels spread over the frame on the CPU
              through `render_pixels` (same settings, same frame, matmuls
              at "highest") and compares: at least 99% of the pixels
              within 1e-3*(1+|ref|), and the mean radiance within 2e-3
              relative. The sampler is stateless per pixel, so both
              backends trace the same samples; they differ only where the
              last bits of sin/exp/log flip a discrete decision (Russian
              roulette, total internal reflection, a grazing hit).
3. gradient - `render_loss_grad` at 256^2, 256 spp must give finite
              gradients; at 64^2, 16 spp the GPU gradients must match the
              CPU's (relative L2 <= 1e-2, cosine >= 0.999).
4. golden   - the tests/golden/*.npz configurations rendered on the GPU,
              held to the bounds of tests/test_golden.py.
5. timing   - report only: compile time, median-of-5 frame time and
              Mrays/s per configuration, with the card's name and power
              limit. Nothing here is asserted.

`--four` runs `render_frame_sharded` and `train_step_sharded`
(`parallel/sharding.py`) over four cards on meshes (4, 1) and (2, 2) in
one process, against single-card `render_frame` and `render_loss_grad`
(1e-5 relative: only the order of reduction differs).

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
ONE_CARD_PHASES = ("device", "forward", "gradient", "golden", "timing")
FOUR_CARD_PHASES = ("device", "four")
N_CHECK_PIXELS = 4096


class PhaseFailed(Exception):
    pass


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    return ap.parse_args(argv)


def selected_phases(args: argparse.Namespace) -> tuple:
    return FOUR_CARD_PHASES if args.four else ONE_CARD_PHASES


def log(msg: str):
    print(msg, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# Configurations (full width; weights are the scenes' own, data is seeded)
# ---------------------------------------------------------------------------

def configs():
    """name -> (scene, camera, settings). The three bench.py
    configurations plus the envmap-importance ladder configuration."""
    import halogen_tpu as ht
    from halogen_tpu.scene import cornell, meshes
    from halogen_tpu.scene.envmap import Envmap

    cornell_cam = ht.make_camera(position=(0.0, 0.0, 3.2),
                                 target=(0.0, 0.0, 0.0), fov_deg=40.0)
    dragon_cam = ht.make_camera(position=(0, 1.5, 5.0), target=(0, -0.3, 0),
                                fov_deg=45)
    demo_cam = ht.make_camera(position=(0, 2.0, 6.0), target=(0, 0, -1),
                              fov_deg=45)
    cornell_scene = cornell.cornell_box(glossy=True).build()
    chunk = 262144
    return {
        "cornell_fwd": (cornell_scene, cornell_cam, ht.RenderSettings(
            width=512, height=512, samples_per_pixel=32, max_bounces=6,
            ray_chunk_size=chunk)),
        "cornell_grad": (cornell_scene, cornell_cam, ht.RenderSettings(
            width=256, height=256, samples_per_pixel=256, max_bounces=6,
            ray_chunk_size=chunk)),
        "glass_dragon": (meshes.glass_dragon_scene().build(), dragon_cam,
                         ht.RenderSettings(width=512, height=512,
                                           samples_per_pixel=32,
                                           max_bounces=12,
                                           ray_chunk_size=chunk)),
        "envmap_nee": (
            cornell.material_demo_spheres().build(
                envmap=Envmap.gradient_sky()),
            demo_cam,
            ht.RenderSettings(width=1024, height=1024, samples_per_pixel=16,
                              max_bounces=4, use_envmap=True,
                              env_importance_sampling=True, env_mip_level=0,
                              ray_chunk_size=chunk)),
    }


def check_pixels(width: int, height: int):
    """A fixed 64 x 64 grid of flat pixel ids spread over the frame."""
    import numpy as np

    side = int(np.sqrt(N_CHECK_PIXELS))
    xs = (np.arange(side) * width) // side + width // (2 * side)
    ys = (np.arange(side) * height) // side + height // (2 * side)
    return (ys[:, None] * width + xs[None, :]).reshape(-1).astype(np.int32)


def cpu_render_pixels(scene, camera, settings, frame, pix):
    """The CPU reference: `render_pixels` on the host CPU device."""
    import jax
    import numpy as np
    from halogen_tpu.integrator.trace import render_pixels

    cpu = jax.devices("cpu")[0]
    fn = jax.jit(render_pixels, static_argnames=("settings",))
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        s, c = jax.device_put((scene, camera), cpu)
        out = fn(s, c, settings, jax.device_put(np.uint32(frame), cpu),
                 jax.device_put(pix, cpu))
        return np.asarray(out)


def compare_to_cpu(name, img, scene, camera, settings, frame):
    import numpy as np

    pix = check_pixels(settings.width, settings.height)
    got = img.reshape(-1, 3)[pix]
    ref = cpu_render_pixels(scene, camera, settings, frame, pix)
    check(np.isfinite(ref).all(), f"{name}: CPU reference not finite")
    diff = np.abs(got - ref)
    ok_px = np.all(diff <= 1e-3 * (1.0 + np.abs(ref)), axis=-1)
    frac = float(ok_px.mean())
    mean_rel = float(abs(got.mean() - ref.mean())
                     / max(abs(ref.mean()), 1e-12))
    log(f"forward {name}: {settings.width}x{settings.height} "
        f"{settings.samples_per_pixel}spp {settings.max_bounces} bounces, "
        f"{pix.size} px vs CPU: within_tol_fraction={frac} "
        f"max_abs_diff={float(diff.max())} mean_rel_diff={mean_rel} "
        f"gpu_mean={float(got.mean())} cpu_mean={float(ref.mean())}")
    check(frac >= 0.99, f"{name}: only {frac:.4f} of pixels within tol")
    check(mean_rel <= 2e-3, f"{name}: mean radiance off by {mean_rel:.2e}")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(state):
    import jax
    from halogen_tpu.utils.device import card_name_and_power_limit, \
        device_info

    info = device_info()
    log(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")
    check(info["platform"] == "gpu",
          f"JAX's default device is {info['platform']!r}, not a GPU")
    state["card"] = card_name_and_power_limit()
    log(f"card (name, power.limit): {state['card']}")
    state["device"] = info
    log(f"cpu reference device: {jax.devices('cpu')[0]}")


def phase_forward(state):
    import jax.numpy as jnp
    import numpy as np
    import halogen_tpu as ht

    state["configs"] = cfgs = configs()
    state["timing"] = {}
    frame = 1
    for i, (name, (scene, cam, st)) in enumerate(cfgs.items()):
        t0 = time.perf_counter()
        if i == 0:
            # the progressive viewer's entry point: frame 1 of an
            # accumulation is exactly render_frame(frame=1)
            img = ht.Renderer(scene, cam, st).render(frames=1)
        else:
            img = np.asarray(ht.render_frame(scene, cam, st,
                                             jnp.uint32(frame)))
        first_s = time.perf_counter() - t0
        check(img.shape == (st.height, st.width, 3),
              f"{name}: image shape {img.shape}")
        check(bool(np.isfinite(img).all()), f"{name}: non-finite pixels")
        # steady-state frames for the timing phase (same executable)
        times = []
        for f in range(5):
            t0 = time.perf_counter()
            ht.render_frame(scene, cam, st,
                            jnp.uint32(frame + 1 + f)).block_until_ready()
            times.append(time.perf_counter() - t0)
        state["timing"][name] = (first_s, times, st)
        compare_to_cpu(name, img, scene, cam, st, frame)


def _flat_grads(grads):
    import jax
    import numpy as np

    leaves = [np.asarray(g, np.float64).reshape(-1)
              for g in jax.tree.leaves(grads)
              if np.issubdtype(np.asarray(g).dtype, np.floating)]
    return np.concatenate(leaves)


def phase_gradient(state):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from halogen_tpu.diff.grad import render_loss_grad

    scene, cam, st = state["configs"]["cornell_grad"]
    params = {"materials": scene.materials}
    target = jnp.zeros((st.height, st.width, 3), jnp.float32)
    t0 = time.perf_counter()
    loss, grads = render_loss_grad(params, scene, cam, st, target,
                                   jnp.uint32(1))
    jax.block_until_ready((loss, grads))
    first_s = time.perf_counter() - t0
    g = _flat_grads(grads)
    log(f"gradient cornell_grad: {st.width}x{st.height} "
        f"{st.samples_per_pixel}spp loss={float(loss)} |g|={np.linalg.norm(g)}"
        f" finite={bool(np.isfinite(g).all())}")
    check(np.isfinite(float(loss)) and np.isfinite(g).all(),
          "cornell_grad: non-finite loss or gradients")
    times = []
    for f in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(render_loss_grad(
            params, scene, cam, st, target, jnp.uint32(2 + f)))
        times.append(time.perf_counter() - t0)
    state["timing"]["cornell_grad fwd+bwd"] = (first_s, times, st)

    small = st.replace(width=64, height=64, samples_per_pixel=16)
    target = jnp.full((64, 64, 3), 0.25, jnp.float32)
    _, g_gpu = render_loss_grad(params, scene, cam, small, target,
                                jnp.uint32(1))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        p_c, s_c, c_c, t_c = jax.device_put((params, scene, cam, target), cpu)
        _, g_cpu = render_loss_grad(p_c, s_c, c_c, small, t_c,
                                    jax.device_put(np.uint32(1), cpu))
    a, b = _flat_grads(g_gpu), _flat_grads(g_cpu)
    rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    cos = float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))
    log(f"gradient 64x64 16spp GPU vs CPU: rel_l2={rel} cosine={cos}")
    check(rel <= 1e-2, f"gradient rel L2 {rel:.3e} > 1e-2")
    check(cos >= 0.999, f"gradient cosine {cos:.6f} < 0.999")


def phase_golden(state):
    import numpy as np
    import halogen_tpu as ht

    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import gen_goldens
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    for name, (scene, cam, st, frame) in gen_goldens.configs().items():
        golden = np.load(ROOT / "tests" / "golden" / f"{name}.npz")["image"]
        img = np.asarray(ht.render_frame(scene, cam, st, frame), np.float32)
        mae_tol, worst_tol = gen_goldens.TOLERANCES.get(
            name, gen_goldens.DEFAULT_TOLERANCE)
        mae = float(np.abs(img - golden).mean())
        worst = float(np.abs(img - golden).max())
        log(f"golden {name}: mae={mae} (tol {mae_tol}) worst={worst} "
            f"(tol {worst_tol})")
        check(img.shape == golden.shape and np.isfinite(img).all(),
              f"golden {name}: bad shape or non-finite pixels")
        check(mae < mae_tol and worst < worst_tol,
              f"golden {name}: outside its bounds")


def phase_timing(state):
    import jax
    import numpy as np

    for name, (first_s, times, st) in state["timing"].items():
        med = float(np.median(times))
        rays = st.samples_per_pixel * st.width * st.height
        log(f"timing {name}: {st.width}x{st.height} {st.samples_per_pixel}spp "
            f"{st.max_bounces} bounces: first_call_s={first_s} "
            f"compile_s~={first_s - med} frame_s_median={med} "
            f"frame_s_all={times} mrays_per_s={rays / med / 1e6} "
            f"card=\"{state['card']}\"")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


def phase_four(state):
    """Sharded render and train step over four cards vs one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import halogen_tpu as ht
    from halogen_tpu.diff.grad import (
        material_params, project_material_params, render_loss_grad)
    from halogen_tpu.parallel.sharding import (
        loss_and_grads_sharded, make_render_mesh, render_frame_sharded,
        train_step_sharded)

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 devices, found {len(devs)}")
    cfgs = configs()
    scene, cam, st = cfgs["cornell_fwd"]
    gscene, gcam, gst = cfgs["cornell_grad"]
    frame = jnp.uint32(1)
    ref_img = np.asarray(ht.render_frame(scene, cam, st, frame))
    target = jnp.full((gst.height, gst.width, 3), 0.25, jnp.float32)
    params = {"materials": gscene.materials}
    ref_loss, ref_g = render_loss_grad(params, gscene, gcam, gst, target,
                                       frame)
    ref_gm = {k: np.asarray(getattr(ref_g["materials"], k))
              for k in material_params(gscene.materials)}
    lr = 1e-2

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    for shape in ((4, 1), (2, 2)):
        mesh = make_render_mesh(*shape, devices=devs)
        t0 = time.perf_counter()
        img = np.asarray(render_frame_sharded(scene, cam, st, frame, mesh))
        t_render = time.perf_counter() - t0
        r_img = rel(img, ref_img)
        px_off = float(np.mean(np.abs(img - ref_img)
                               > 1e-5 * (1.0 + np.abs(ref_img))))
        _, grads = loss_and_grads_sharded(
            material_params(gscene.materials), gscene, gcam, gst, target,
            frame, mesh)
        r_grad = max(rel(grads[k], ref_gm[k]) for k in ref_gm
                     if np.linalg.norm(ref_gm[k]) > 0)
        t0 = time.perf_counter()
        new_mats, loss = train_step_sharded(gscene.materials, gscene, gcam,
                                            gst, target, frame, mesh, lr=lr)
        jax.block_until_ready((new_mats, loss))
        t_step = time.perf_counter() - t0
        expect = project_material_params(jax.tree.map(
            lambda p, g: p - lr * g, material_params(gscene.materials),
            ref_gm))
        r_step = max(rel(getattr(new_mats, k), expect[k]) for k in expect)
        r_loss = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        log(f"four mesh={shape}: render rel={r_img} "
            f"pixel_fraction_off={px_off} loss rel={r_loss} "
            f"grad rel(max over fields)={r_grad} step rel={r_step} "
            f"first_render_s={t_render} first_step_s={t_step}")
        check(np.isfinite(img).all(), f"mesh {shape}: non-finite image")
        check(r_img <= 1e-5, f"mesh {shape}: render rel {r_img:.2e} > 1e-5")
        check(r_loss <= 1e-5, f"mesh {shape}: loss rel {r_loss:.2e} > 1e-5")
        check(r_grad <= 1e-5, f"mesh {shape}: grad rel {r_grad:.2e} > 1e-5")
        check(r_step <= 1e-5, f"mesh {shape}: step rel {r_step:.2e} > 1e-5")


PHASE_FNS = {
    "device": phase_device, "forward": phase_forward,
    "gradient": phase_gradient, "golden": phase_golden,
    "timing": phase_timing, "four": phase_four,
}


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from halogen_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    state = {}
    for name in selected_phases(args):
        t0 = time.perf_counter()
        try:
            PHASE_FNS[name](state)
        except PhaseFailed as e:
            log(f"phase {name} FAILED: {e}")
            return 1
        log(f"phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"ok": True, "device": state["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
