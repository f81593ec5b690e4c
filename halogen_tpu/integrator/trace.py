"""The path-tracing integrator: bounce loop, sky shading, Russian roulette,
debug views, and the per-frame renderer.

A JAX re-implementation of the reference megakernel
(`HalgoenCompute.compute:876-1063`): instead of one GPU thread per pixel
with divergent control flow, rays live in flat SoA arrays and the bounce
loop advances all rays in lockstep, as whole-array XLA ops with per-ray
active masks.
Two schedulers share one bounce implementation (`_pool_bounce`):

- **lockstep** (`trace_rays`, default): `lax.scan` over bounces on the full
  ray pool; terminated lanes are masked. Reverse-differentiable — the scan
  is `jax.checkpoint`-ed, giving path-replay backprop.
- **wavefront** (`trace_rays_wavefront`, `settings.wavefront`): the
  SURVEY.md §2 #14 design — per bounce, the pool is compacted (active rays
  sorted to the front) and a `lax.while_loop` with a data-dependent trip
  count processes only the live blocks. Deep-bounce scenes with Russian
  roulette stop paying for dead lanes. The raw while_loop has no transpose,
  so the public path routes through `trace_rays_wavefront_diff`: a
  custom_vjp whose primal is the wavefront forward and whose backward is
  the vjp of the lockstep tracer — valid because the two schedulers are
  bit-identical per ray (asserted by tests/test_wavefront.py), and exactly
  the path-replay decomposition (the backward re-traces from the saved
  inputs rather than storing the path).

Semantics preserved (trace_ray, compute:876-950):
- per-ray-type bounce limits checked at loop top with `>` (compute:869-871)
- emission accumulated before BRDF evaluation (compute:901-902)
- Russian roulette with 1/p compensation after every hit (compute:923-936)
- miss -> environment sample with the accumulated-roughness mip bias
  (QUESTIONABLE_IMPORTANCE_SAMPLING, compute:940-945), including the
  reference's float3->float truncation quirk in the roughness accumulator
  (compute:911 adds `roughness * lightAttenuation` to a scalar: .x wins)
- sampler dimensions advance by 5 per bounce (compute:921)
"""

from __future__ import annotations

import functools
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from halogen_tpu.config import DebugMode, RenderSettings, SamplerKind
from halogen_tpu.core.math import (
    gather_rows,
    procedural_glossy_pdf,
    reflect,
)
from halogen_tpu.core.medium import MediumStack
from halogen_tpu.core.types import SceneData
from halogen_tpu.integrator.camera import Camera, generate_rays
from halogen_tpu.integrator.intersect import intersect_scene
from halogen_tpu.integrator.shade import evaluate_material_hit, gather_materials
from halogen_tpu.sampler import sobol as sob
from halogen_tpu.scene.envmap import (
    env_pdf,
    sample_env_draw,
    sample_env_packed,
)
from halogen_tpu.scene.lights import sample_light, sphere_cone_pdf


def _sampler_2d(settings: RenderSettings):
    if settings.sampler == SamplerKind.PRNG:
        return sob.prng_sample_2d
    return sob.ld_sample_2d


def _sampler_1d(settings: RenderSettings):
    if settings.sampler == SamplerKind.PRNG:
        return sob.prng_sample_1d
    return sob.ld_sample_1d


def _use_nee(scene: SceneData, settings: RenderSettings) -> bool:
    """Envmap NEE is active only when the flag, the map, and its CDF
    tables are all present (static decision)."""
    return (
        settings.use_envmap
        and settings.env_importance_sampling
        and scene.env_cdf is not None
        and bool(scene.env_mips)
    )


def _use_light_nee(scene: SceneData, settings: RenderSettings) -> bool:
    """Area-light NEE requires the flag and a non-empty emissive-triangle
    table (static decision)."""
    return settings.light_importance_sampling and scene.lights is not None


def sample_sky(
    scene: SceneData, direction: jnp.ndarray, level: jnp.ndarray,
    settings: RenderSettings,
) -> jnp.ndarray:
    """Environment lookup (sample_sky, compute:196-204): black when no
    envmap is bound."""
    if not settings.use_envmap or not scene.env_mips:
        return jnp.zeros(direction.shape[:-1] + (3,), jnp.float32)
    # footprint-packed row gathers: one gather per bilinear tap instead
    # of four (identical taps/blends — see envmap.sample_env_packed)
    return sample_env_packed(scene.env_mips, direction, level)


class Pool(NamedTuple):
    """Per-ray SoA state advanced by `_pool_bounce` (any leading length)."""

    origin: jnp.ndarray
    direction: jnp.ndarray
    attenuation: jnp.ndarray
    color: jnp.ndarray
    acc_roughness: jnp.ndarray
    counts: jnp.ndarray  # [N, 3] bounce-type counts
    stack: MediumStack
    active: jnp.ndarray
    tri_tests: jnp.ndarray
    box_tests: jnp.ndarray
    first_t: jnp.ndarray
    first_albedo: jnp.ndarray
    first_normal: jnp.ndarray
    # MIS state for NEE: was the previous scatter an NEE-covered diffuse
    # lobe (env / area-light variants), and its cosine pdf for the
    # continuation direction (shared — it is the same density).
    prev_nee: jnp.ndarray
    prev_lnee: jnp.ndarray
    prev_pcos: jnp.ndarray
    # Per-ray sampler inputs + clip distance (carried so the pool can be
    # permuted/sliced freely by the wavefront scheduler).
    sample_idx: jnp.ndarray
    seed: jnp.ndarray
    far: jnp.ndarray


def _make_pool(origin, direction, far, sample_idx, seed) -> Pool:
    n = origin.shape[0]
    return Pool(
        origin=origin,
        direction=direction,
        attenuation=jnp.ones((n, 3), jnp.float32),
        color=jnp.zeros((n, 3), jnp.float32),
        acc_roughness=jnp.zeros((n,), jnp.float32),
        counts=jnp.zeros((n, 3), jnp.int32),
        stack=MediumStack.create(n),
        active=jnp.ones((n,), bool),
        tri_tests=jnp.zeros((n,), jnp.int32),
        box_tests=jnp.zeros((n,), jnp.int32),
        first_t=jnp.full((n,), np.inf, jnp.float32),
        first_albedo=jnp.zeros((n, 3), jnp.float32),
        first_normal=jnp.zeros((n, 3), jnp.float32),
        prev_nee=jnp.zeros((n,), bool),
        prev_lnee=jnp.zeros((n,), bool),
        prev_pcos=jnp.zeros((n,), jnp.float32),
        sample_idx=jnp.broadcast_to(sample_idx, (n,)).astype(jnp.uint32),
        seed=jnp.broadcast_to(seed, (n,)).astype(jnp.uint32),
        far=jnp.broadcast_to(far, (n,)),
    )


def _pool_bounce(
    scene: SceneData, settings: RenderSettings, carry: Pool, k
) -> Pool:
    """One bounce of every ray in `carry` (the megakernel body,
    trace_ray compute:876-950). Pure function of the pool — both
    schedulers call this on full pools or compacted slices."""
    n = carry.origin.shape[0]
    s2 = _sampler_2d(settings)
    s1 = _sampler_1d(settings)
    use_nee = _use_nee(scene, settings)
    use_lnee = _use_light_nee(scene, settings)
    sample_idx, seed, far = carry.sample_idx, carry.seed, carry.far

    # --- per-type termination check at loop top (compute:891-893)
    over = (
        (carry.counts[:, 0] > settings.max_diffuse_bounces)
        | (carry.counts[:, 1] > settings.max_glossy_bounces)
        | (carry.counts[:, 2] > settings.max_transmission_bounces)
    )
    active = carry.active & (~over)

    # Dead lanes get far = 0: they fail every AABB/leaf test, so the BVH
    # walk stops carrying them (under Russian roulette most of the pool
    # is dead after a few bounces). Correctness is unaffected — every
    # consumer of this bounce's hit is masked by `active`.
    far_eff = jnp.where(active, far, 0.0)
    hit, tt, bt = intersect_scene(
        scene, carry.origin, carry.direction, far_eff, settings
    )
    is_hit = active & (hit.t < far)  # compute:898
    mat = gather_materials(scene.materials, hit.material)

    first = k == 0
    first_t = jnp.where(first, hit.t, carry.first_t)
    first_albedo = jnp.where(first, mat.albedo, carry.first_albedo)
    first_normal = jnp.where(first, hit.normal, carry.first_normal)

    # --- emission (compute:901-902). With area-light NEE on, emission
    # reached via an NEE-covered diffuse continuation is MIS-weighted
    # (balance heuristic vs the light table's solid-angle density at this
    # hit); sphere emitters have pdf_area 0 -> weight 1.
    emission = mat.emissive_rgb * mat.emissive_intensity[:, None]
    em_w = jnp.ones((n,), jnp.float32)
    if use_lnee:
        # triangle emitters: area pdf -> solid angle at this hit
        pdf_area_hit = jnp.where(
            hit.tri >= 0,
            gather_rows(scene.tri_light_pdf_area,
                        jnp.maximum(hit.tri, 0)), 0.0)
        cos_hit = jnp.abs(jnp.sum(carry.direction * hit.normal, axis=-1))
        t_safe = jnp.where(jnp.isfinite(hit.t), hit.t, 0.0)
        pdf_sa_hit = pdf_area_hit * t_safe * t_safe / jnp.maximum(
            cos_hit, 1e-6)
        # sphere emitters: cone-sampling pdf from the previous origin
        if scene.num_spheres:
            sp = jnp.maximum(hit.sphere, 0)
            sph_pdf = sphere_cone_pdf(
                gather_rows(scene.sphere_light_sel, sp),
                gather_rows(scene.sphere_center, sp),
                gather_rows(scene.sphere_radius, sp),
                carry.origin,
            )
            pdf_sa_hit = jnp.where(hit.sphere >= 0, sph_pdf, pdf_sa_hit)
        w_cont = carry.prev_pcos / jnp.maximum(
            carry.prev_pcos + pdf_sa_hit, 1e-12)
        em_w = jnp.where(carry.prev_lnee & (pdf_sa_hit > 0.0), w_cont, em_w)
    color = carry.color + jnp.where(
        (active & is_hit)[:, None],
        emission * carry.attenuation * em_w[:, None], 0.0
    )

    # --- sampler dims for this bounce (base + 5*k, compute:921)
    ku = k.astype(jnp.uint32) if hasattr(k, "astype") else jnp.uint32(k)
    stride = jnp.uint32(sob.BOUNCE_DIM_STRIDE) * ku
    refl_rand = s2(sample_idx, jnp.uint32(sob.DIM_ROUGH_REFLECTION) + stride,
                   seed)
    prop_rand = s2(sample_idx, jnp.uint32(sob.DIM_MATERIAL_BRDF) + stride,
                   seed)
    rr_rand = s1(sample_idx, jnp.uint32(sob.DIM_RUSSIAN_ROULETTE) + stride,
                 seed)

    shade_mask = active & is_hit
    shaded = evaluate_material_hit(
        carry.direction, hit, mat, carry.stack, shade_mask,
        refl_rand, prop_rand,
        any_transmissive=scene.any_transmissive,
    )

    sm = shade_mask[:, None]
    new_origin = jnp.where(sm, shaded.origin, carry.origin)
    new_dir = jnp.where(sm, shaded.direction, carry.direction)
    atten = jnp.where(sm, carry.attenuation * shaded.attenuation,
                      carry.attenuation)

    # --- next-event estimation + MIS (capability beyond the reference;
    # its own MIS TODO, HalgoenCompute.compute:19). Covers every OPAQUE
    # lobe: the continuation strategy's solid-angle density has a closed
    # form — (1-ps)*cos/pi for the diffuse branch plus ps times the
    # procedural glossy lobe's exact pdf (core.math.procedural_glossy_pdf,
    # the cosine density pushed through the reference's normalize-lerp
    # map). Pure mirrors (roughness 0) are a delta: no NEE coverage,
    # continuation weight 1. Transmissive lanes keep plain BRDF sampling.
    surf_lane = shade_mask & (mat.alpha >= 1.0)
    if use_nee or use_lnee:
        # Sampling-strategy quantities are DETACHED (stop_gradient):
        # pdfs/MIS weights belong to the detached sampling decomposition,
        # and their kinks (sqrt at disc=0, schlick at TIR) would blow up
        # the backward pass. Value factors (albedo/specular) stay live.
        ps = jax.lax.stop_gradient(shaded.spec_prob)
        a2 = jax.lax.stop_gradient(mat.roughness * mat.roughness)
        mirror = jax.lax.stop_gradient(reflect(carry.direction, hit.normal))

        def mix_pdf(wdir):
            """Continuation density of the reference's procedural
            mixture at direction wdir (detached)."""
            c = jnp.maximum(jnp.sum(hit.normal * wdir, axis=-1), 0.0)
            p_gl = procedural_glossy_pdf(wdir, mirror, a2, hit.normal)
            return jax.lax.stop_gradient(
                (1.0 - ps) * c * np.float32(1.0 / np.pi) + ps * p_gl)

        cos_nd = jnp.sum(hit.normal * new_dir, axis=-1)
        covered = (
            surf_lane & (cos_nd > 0.0) & (shaded.bounce_type != 2)
            & ~((shaded.bounce_type == 1) & (a2 <= 1e-6))  # mirror delta
        )
        prev_pcos = jnp.where(covered, mix_pdf(new_dir), 0.0)
    else:
        prev_pcos = carry.prev_pcos
        covered = jnp.zeros_like(shade_mask)
    prev_nee = carry.prev_nee
    prev_lnee = carry.prev_lnee

    if use_nee:
        dim_nee = jnp.uint32(sob.DIM_ENV_NEE_BASE) + stride
        nu, nv = s2(sample_idx, dim_nee, seed)
        ldir, lpdf, radiance = sample_env_draw(
            scene.env_cdf, scene.env_mips[0], nu, nv)
        cos_l = jnp.sum(hit.normal * ldir, axis=-1)
        cand = surf_lane & (cos_l > 0.0) & (lpdf > 1e-12)
        sh_origin = hit.pos + hit.normal * 1e-4
        sh_hit, _, _ = intersect_scene(scene, sh_origin, ldir, far_eff,
                                       settings)
        visible = sh_hit.t >= far
        # Radiance is the exact texel the pdf tables were built from
        # (fused into the one-row draw gather): a filtered or
        # coarser-mip lookup would spread bright texels onto neighbors
        # whose pdf is tiny -> giant-weight fireflies. The
        # env_mip_level knob remains a BRDF-path-only bias, as in the
        # reference.
        p_gl_l = jax.lax.stop_gradient(
            procedural_glossy_pdf(ldir, mirror, a2, hit.normal))
        p_mix_l = jax.lax.stop_gradient(
            (1.0 - ps) * jnp.maximum(cos_l, 0.0) * np.float32(1.0 / np.pi)
            + ps * p_gl_l)
        # f*cos of the procedural model: the sampled-attenuation identity
        # f*cos = density * attenuation per branch
        f_cos = (
            mat.albedo * ((1.0 - ps) * cos_l
                          * np.float32(1.0 / np.pi))[:, None]
            + mat.specular * (ps * p_gl_l)[:, None]
        )
        w_nee = lpdf / (lpdf + p_mix_l)
        contrib = (
            carry.attenuation * f_cos * radiance
            * (w_nee / jnp.maximum(lpdf, 1e-12))[:, None]
        )
        color = color + jnp.where((cand & visible)[:, None], contrib, 0.0)
        prev_nee = covered

    # --- area-light next-event estimation + MIS (see scene/lights.py):
    # one emissive triangle OR sphere per diffuse bounce, chosen by the
    # power CDF. Same diffuse-lane restriction and balance heuristic as
    # envmap NEE.
    if use_lnee:
        u_sel = s1(sample_idx, jnp.uint32(sob.DIM_LIGHT_NEE_SEL) + stride,
                   seed)
        pu, pv = s2(sample_idx, jnp.uint32(sob.DIM_LIGHT_NEE_POINT) + stride,
                    seed)
        ls = sample_light(scene.lights, scene, u_sel, pu, pv)
        is_tri = ls["kind"] == 0

        # triangle branch: direction to the sampled surface point
        wi_vec = ls["tri_point"] - hit.pos
        d2 = jnp.sum(wi_vec * wi_vec, axis=-1)
        dist_t = jnp.sqrt(jnp.maximum(d2, 1e-12))
        wi_t = wi_vec / dist_t[:, None]
        gn_hat = ls["gn"] / jnp.maximum(
            jnp.linalg.norm(ls["gn"], axis=-1, keepdims=True), 1e-12)
        cos_l = jnp.abs(jnp.sum(gn_hat * wi_t, axis=-1))
        pdf_sa_t = ls["pdf_area"] * d2 / jnp.maximum(cos_l, 1e-6)
        ok_t = (cos_l > 1e-4) & (ls["pdf_area"] > 0.0) \
            & (ls["idx"] != hit.tri)

        # sphere branch: uniform direction in the subtended cone
        dvec = ls["center"] - hit.pos
        dc2 = jnp.sum(dvec * dvec, axis=-1)
        dc = jnp.sqrt(jnp.maximum(dc2, 1e-12))
        dhat = dvec / dc[:, None]
        sin2max = ls["radius"] ** 2 / jnp.maximum(dc2, 1e-12)
        outside = sin2max < 1.0
        cos_max = jnp.sqrt(jnp.clip(1.0 - sin2max, 0.0, 1.0))
        cos_th = 1.0 - pu * (1.0 - cos_max)
        sin_th = jnp.sqrt(jnp.clip(1.0 - cos_th * cos_th, 0.0, 1.0))
        phi = pv * np.float32(2.0 * np.pi)
        # orthonormal basis around dhat
        up = jnp.where((jnp.abs(dhat[:, 1:2]) < 0.9),
                       jnp.asarray([[0.0, 1.0, 0.0]]),
                       jnp.asarray([[1.0, 0.0, 0.0]]))
        tang = jnp.cross(up, dhat)
        tang = tang / jnp.maximum(
            jnp.linalg.norm(tang, axis=-1, keepdims=True), 1e-12)
        bitan = jnp.cross(dhat, tang)
        wi_s = (dhat * cos_th[:, None]
                + tang * (sin_th * jnp.cos(phi))[:, None]
                + bitan * (sin_th * jnp.sin(phi))[:, None])
        solid = np.float32(2.0 * np.pi) * (1.0 - cos_max)
        pdf_sa_s = ls["sel"] / jnp.maximum(solid, 1e-12)
        # distance to the sphere surface along wi_s
        proj = dc * cos_th
        under = ls["radius"] ** 2 - dc2 * sin_th * sin_th
        dist_s = proj - jnp.sqrt(jnp.clip(under, 0.0, None))
        ok_s = outside & (solid > 1e-12) & (ls["idx"] != hit.sphere)

        km = is_tri[:, None]
        wi = jnp.where(km, wi_t, wi_s)
        dist = jnp.where(is_tri, dist_t, dist_s)
        pdf_sa = jnp.where(is_tri, pdf_sa_t, pdf_sa_s)
        ok = jnp.where(is_tri, ok_t, ok_s)
        cos_s = jnp.sum(hit.normal * wi, axis=-1)
        cand_l = surf_lane & ok & (cos_s > 0.0)

        # shadow ray: visible iff nothing sits in front of the light —
        # the closest hit is the sampled light itself (or beyond the
        # sampled point, for grazing shared-edge cases on tri lights)
        sh_origin = hit.pos + hit.normal * 1e-4
        lsh_hit, _, _ = intersect_scene(scene, sh_origin, wi, far_eff,
                                        settings)
        hit_self = jnp.where(
            is_tri, lsh_hit.tri == ls["idx"], lsh_hit.sphere == ls["idx"])
        visible_l = hit_self | (lsh_hit.t >= dist * np.float32(1.0 - 1e-3))

        lmat_id = jnp.where(
            is_tri,
            gather_rows(scene.tri_material,
                        jnp.maximum(jnp.where(is_tri, ls["idx"], 0), 0))
            if scene.num_triangles else 0,
            gather_rows(scene.sphere_material,
                        jnp.maximum(jnp.where(is_tri, 0, ls["idx"]), 0))
            if scene.num_spheres else 0,
        )
        l_emissive = gather_rows(scene.materials.emissive, lmat_id)  # [N, 4]
        l_em = l_emissive[:, :3] * l_emissive[:, 3][:, None]
        p_gl_s = jax.lax.stop_gradient(
            procedural_glossy_pdf(wi, mirror, a2, hit.normal))
        p_mix_s = jax.lax.stop_gradient(
            (1.0 - ps) * jnp.maximum(cos_s, 0.0) * np.float32(1.0 / np.pi)
            + ps * p_gl_s)
        w_l = pdf_sa / jnp.maximum(pdf_sa + p_mix_s, 1e-12)
        f_cos_l = (
            mat.albedo * ((1.0 - ps) * cos_s
                          * np.float32(1.0 / np.pi))[:, None]
            + mat.specular * (ps * p_gl_s)[:, None]
        )
        contrib_l = (
            carry.attenuation * f_cos_l * l_em
            * (w_l / jnp.maximum(pdf_sa, 1e-12))[:, None]
        )
        color = color + jnp.where(
            (cand_l & visible_l)[:, None], contrib_l, 0.0)
        prev_lnee = covered

    # Bounce-type counts (compute:796,807)
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (n, 3), 1)
        == shaded.bounce_type[:, None]
    )
    counts = carry.counts + jnp.where(sm & onehot, 1, 0).astype(jnp.int32)

    # Roughness accumulator quirk: scalar += roughness * attenuation.x
    # (compute:911 with HLSL float3->float truncation)
    acc_roughness = carry.acc_roughness + jnp.where(
        shade_mask, mat.roughness * atten[:, 0], 0.0
    )

    # --- Russian roulette (compute:923-936). The 1/p boost applies
    # only to surviving lanes (as in the reference, which divides after
    # the kill test); the double-where keeps the backward pass finite
    # when contribution ~ 0 on dead/black lanes.
    if settings.russian_roulette:
        contribution = jnp.max(atten, axis=1)
        killed = shade_mask & (rr_rand > contribution)
        survive = shade_mask & (~killed)
        safe_c = jnp.where(survive, jnp.maximum(contribution, 1e-20), 1.0)
        atten = jnp.where(survive[:, None], atten / safe_c[:, None], atten)
    else:
        killed = jnp.zeros_like(shade_mask)

    # --- miss: sky emission, ray dies (compute:938-946)
    miss = active & (~is_hit)
    if settings.mip_importance_bias:
        # float level -> trilinear inter-mip blend, like the reference's
        # hardware SampleLevel with the roughness bias (compute:940-945)
        level = (settings.env_mip_level
                 + carry.acc_roughness * settings.mip_importance_range)
    else:
        level = jnp.full((n,), settings.env_mip_level, jnp.float32)
    sky = sample_sky(scene, carry.direction, level, settings)
    sky_w = jnp.ones((n,), jnp.float32)
    if use_nee:
        # MIS weight for BRDF-sampled env hits whose previous scatter
        # was an NEE-covered diffuse lobe (balance heuristic vs the
        # luminance-CDF density).
        p_env_here = env_pdf(scene.env_cdf, carry.direction)
        w_cont = carry.prev_pcos / jnp.maximum(
            carry.prev_pcos + p_env_here, 1e-12
        )
        sky_w = jnp.where(carry.prev_nee, w_cont, sky_w)
    color = color + jnp.where(
        miss[:, None], sky * carry.attenuation * sky_w[:, None], 0.0
    )

    new_active = active & is_hit & (~killed)

    out = carry._replace(
        origin=new_origin,
        direction=new_dir,
        attenuation=atten,
        color=color,
        acc_roughness=acc_roughness,
        counts=counts,
        stack=shaded.stack,
        active=new_active,
        tri_tests=carry.tri_tests + jnp.where(active, tt, 0),
        box_tests=carry.box_tests + jnp.where(active, bt, 0),
        first_t=first_t,
        first_albedo=first_albedo,
        first_normal=first_normal,
        prev_nee=prev_nee,
        prev_lnee=prev_lnee,
        prev_pcos=prev_pcos,
    )
    # Detached-sampling gradient estimator: path geometry (origins and
    # scattered directions) is treated as fixed in the backward pass, so
    # parameter gradients flow only through throughput weights, emission
    # and sky radiance — the standard path-replay decomposition, and it
    # keeps inf/NaN from miss lanes out of the cotangent graph.
    return out._replace(
        origin=jax.lax.stop_gradient(out.origin),
        direction=jax.lax.stop_gradient(out.direction),
    )


class TraceOut(NamedTuple):
    color: jnp.ndarray  # [N, 3]
    tri_tests: jnp.ndarray  # [N] int32 (first segment, for debug heatmaps)
    box_tests: jnp.ndarray  # [N] int32
    first_hit_t: jnp.ndarray  # [N]
    first_hit_albedo: jnp.ndarray  # [N, 3]
    first_hit_normal: jnp.ndarray  # [N, 3]


def _pool_out(pool: Pool) -> TraceOut:
    return TraceOut(
        color=pool.color,
        tri_tests=pool.tri_tests,
        box_tests=pool.box_tests,
        first_hit_t=pool.first_t,
        first_hit_albedo=pool.first_albedo,
        first_hit_normal=pool.first_normal,
    )


def trace_rays(
    scene: SceneData,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    far: jnp.ndarray,
    sample_idx: jnp.ndarray,
    seed: jnp.ndarray,
    settings: RenderSettings,
) -> TraceOut:
    """Lockstep scheduler: scan over bounces on the full ray pool.
    Reverse-differentiable (jax.checkpoint-ed path replay)."""
    pool = _make_pool(origin, direction, far, sample_idx, seed)

    def bounce(pool, k):
        return _pool_bounce(scene, settings, pool, k), None

    ks = jnp.arange(settings.max_bounces + 1, dtype=jnp.int32)
    final, _ = jax.lax.scan(jax.checkpoint(bounce), pool, ks)
    return _pool_out(final)


def trace_rays_wavefront(
    scene: SceneData,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    far: jnp.ndarray,
    sample_idx: jnp.ndarray,
    seed: jnp.ndarray,
    settings: RenderSettings,
) -> TraceOut:
    """Wavefront scheduler (SURVEY.md §2 #14): per bounce, compact active
    rays to the front of the pool (stable sort — deterministic) and run a
    while_loop over only the live blocks. Per-ray results are identical to
    the lockstep scheduler (each ray sees the same op sequence; it just
    runs in a different slot), so images match bit-for-bit; only wasted
    work on dead lanes is skipped. Forward-only."""
    n = origin.shape[0]
    block = max(min(settings.wavefront_block, n), 1)
    pad = (-n) % block
    if pad:
        zeros3 = jnp.zeros((pad, 3), jnp.float32)
        origin = jnp.concatenate([origin, zeros3])
        direction = jnp.concatenate(
            [direction, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (pad, 1))]
        )
        far = jnp.concatenate([far, jnp.zeros((pad,), far.dtype)])
        sample_idx = jnp.concatenate([
            jnp.broadcast_to(sample_idx, (n,)).astype(jnp.uint32),
            jnp.zeros((pad,), jnp.uint32),
        ])
        seed = jnp.concatenate([
            jnp.broadcast_to(seed, (n,)).astype(jnp.uint32),
            jnp.zeros((pad,), jnp.uint32),
        ])
    np_total = n + pad

    pool = _make_pool(origin, direction, far, sample_idx, seed)
    if pad:
        alive = jnp.arange(np_total) < n
        pool = pool._replace(active=pool.active & alive)
    # original slot of the ray currently in each pool position
    idx = jnp.arange(np_total, dtype=jnp.int32)
    n_blocks = np_total // block

    def bounce(state, k):
        pool, idx = state
        # stable compaction: active rays first, original order preserved
        order = jnp.argsort(~pool.active, stable=True)
        pool = jax.tree.map(lambda a: a[order], pool)
        idx = idx[order]
        live_blocks = jnp.minimum(
            (jnp.sum(pool.active) + block - 1) // block, n_blocks
        ).astype(jnp.int32)

        def cond(s):
            return s[0] < live_blocks

        def body(s):
            b, pool = s
            sl = partial(jax.lax.dynamic_slice_in_dim,
                         start_index=b * block, slice_size=block, axis=0)
            sub = jax.tree.map(sl, pool)
            sub = _pool_bounce(scene, settings, sub, k)
            pool = jax.tree.map(
                lambda a, v: jax.lax.dynamic_update_slice_in_dim(
                    a, v, b * block, 0),
                pool, sub,
            )
            return b + 1, pool

        _, pool = jax.lax.while_loop(cond, body, (jnp.int32(0), pool))
        return (pool, idx), None

    ks = jnp.arange(settings.max_bounces + 1, dtype=jnp.int32)
    (pool, idx), _ = jax.lax.scan(bounce, (pool, idx), ks)

    # scatter results back to original ray slots, drop padding
    def unscatter(a):
        out = jnp.zeros_like(a)
        return out.at[idx].set(a)[:n]

    return TraceOut(*(unscatter(x) for x in _pool_out(pool)))


@functools.lru_cache(maxsize=None)
def _diff_wavefront(settings: RenderSettings):
    """custom_vjp wrapper keyed on (hashable) settings: wavefront forward,
    lockstep path-replay backward. Residuals are the call inputs only —
    the backward pass re-traces (replays) every path, so memory stays
    O(ray batch) exactly like the checkpointed lockstep scan."""

    @jax.custom_vjp
    def traced(scene, origin, direction, far, sample_idx, seed):
        return trace_rays_wavefront(
            scene, origin, direction, far, sample_idx, seed, settings)

    def fwd(scene, origin, direction, far, sample_idx, seed):
        out = traced(scene, origin, direction, far, sample_idx, seed)
        return out, (scene, origin, direction, far, sample_idx, seed)

    def bwd(res, ct):
        scene, origin, direction, far, sample_idx, seed = res
        _, vjp = jax.vjp(
            lambda sc, o, d: trace_rays(
                sc, o, d, far, sample_idx, seed, settings),
            scene, origin, direction,
        )
        d_scene, d_o, d_d = vjp(ct)
        f0 = lambda x: np.zeros(x.shape, jax.dtypes.float0)
        return (d_scene, d_o, d_d, jnp.zeros_like(far), f0(sample_idx),
                f0(seed))

    traced.defvjp(fwd, bwd)
    return traced


def trace_rays_wavefront_diff(
    scene: SceneData,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    far: jnp.ndarray,
    sample_idx: jnp.ndarray,
    seed: jnp.ndarray,
    settings: RenderSettings,
) -> TraceOut:
    """Differentiable wavefront tracer (see module docstring): forward runs
    the compacted-block scheduler, reverse-mode runs the lockstep replay.
    Gradients are identical to `trace_rays`' because the two schedulers
    produce bit-identical primals."""
    return _diff_wavefront(settings)(
        scene, origin, direction, far, sample_idx, seed)


def _debug_color(out: TraceOut, scene, direction, far, settings) -> jnp.ndarray:
    """Debug views (trace_ray_debug*, compute:819-863,952-982)."""
    mode = settings.debug_mode
    hit_mask = (out.first_hit_t < far)[:, None]
    level = jnp.full(direction.shape[:-1], settings.env_mip_level, jnp.int32)
    sky = sample_sky(scene, direction, level, settings)
    if mode == DebugMode.ALBEDO:
        return jnp.where(hit_mask, out.first_hit_albedo, sky)
    if mode == DebugMode.NORMAL:
        return jnp.where(hit_mask, (out.first_hit_normal + 1.0) * 0.5, sky)
    tri = out.tri_tests.astype(jnp.float32)
    box = out.box_tests.astype(jnp.float32)
    tri_over = out.tri_tests > settings.triangle_debug_display_range
    box_over = out.box_tests > settings.box_debug_display_range
    tri_n = tri / settings.triangle_debug_display_range
    box_n = box / settings.box_debug_display_range
    zeros = jnp.zeros_like(tri_n)
    if mode == DebugMode.RAY_TRIANGLE_TESTS:
        col = jnp.stack([tri_n, zeros, zeros], axis=-1)
        return jnp.where(tri_over[:, None], 1.0, col)
    if mode == DebugMode.RAY_BOX_TESTS:
        col = jnp.stack([box_n, zeros, zeros], axis=-1)
        return jnp.where(box_over[:, None], 1.0, col)
    # COMBINED
    col = jnp.stack([tri_n, zeros, box_n], axis=-1)
    return jnp.where((tri_over | box_over)[:, None], 1.0, col)


def render_pixels(
    scene: SceneData,
    camera: Camera,
    settings: RenderSettings,
    frame: jnp.ndarray,
    pix: jnp.ndarray,
    spp_offset: int | jnp.ndarray = 0,
    spp_count: int | None = None,
) -> jnp.ndarray:
    """Render flat pixel indices `pix` [n] -> [n, 3] radiance, averaged
    over spp lanes [spp_offset, spp_offset + spp_count).

    The sharding-friendly inner renderer: pixel subsets shard the `pix`
    axis; spp subsets shard the sample-index stream (valid because the
    sampler indexes samples by frame*spp + lane — the SURVEY.md §3.4
    redesign). The spp loop is a scan, so memory is one ray-state batch.
    """
    w, h = settings.width, settings.height
    n = pix.shape[0]
    frame = jnp.asarray(frame, jnp.uint32)
    spp = settings.samples_per_pixel if spp_count is None else spp_count

    px = pix % w
    py = pix // w
    seed = sob.pixel_seed(pix.astype(jnp.uint32))
    tracer = trace_rays_wavefront_diff if settings.wavefront else trace_rays

    # Fold spp lanes into the ray axis: each bounce step then carries up
    # to ray_chunk_size rays instead of one [n] batch per spp lane, so the
    # fixed cost of each op is paid over more rays. Results are identical
    # — the sampler indexes by (frame, spp lane), so lanes are independent
    # (SURVEY.md §3.4).
    max_block = max(1, settings.ray_chunk_size // max(n, 1))
    spp_block = 1
    for cand in range(min(spp, max_block), 0, -1):
        if spp % cand == 0:
            spp_block = cand
            break
    groups = spp // spp_block
    nb = n * spp_block
    # PIXEL-major fold: all spp lanes of a pixel sit next to each other,
    # so neighbouring rays see near-identical geometry. Per-ray results
    # are unchanged (the sampler keys on (frame, lane), not slot).
    pxb = jnp.repeat(px, spp_block)
    pyb = jnp.repeat(py, spp_block)
    seedb = jnp.repeat(seed, spp_block)
    farb = jnp.broadcast_to(camera.far, (nb,))
    lane = jnp.tile(jnp.arange(spp_block, dtype=jnp.uint32), n)

    def spp_body(acc, g):
        lanes = jnp.uint32(spp_offset) + g * jnp.uint32(spp_block) + lane
        sidx = sob.sample_index(frame, lanes, settings.samples_per_pixel)
        o, d = generate_rays(
            camera, pxb, pyb, w, h, settings.filter_radius,
            sidx, seedb, _sampler_2d(settings),
        )
        out = tracer(scene, o, d, farb, sidx, seedb, settings)
        if settings.debug_mode != DebugMode.NONE:
            col = _debug_color(out, scene, d, farb, settings)
        else:
            col = out.color
        return acc + col.reshape(n, spp_block, 3).sum(axis=1), None

    acc, _ = jax.lax.scan(
        spp_body,
        jnp.zeros((n, 3), jnp.float32),
        jnp.arange(groups, dtype=jnp.uint32),
    )
    return acc / spp


@functools.lru_cache(maxsize=None)
def _morton_pixel_order(w: int, h: int):
    """Static Z-order (Morton) permutation of the pixel grid.

    Rays are laid out in `pix` order, so this makes every contiguous run
    of rays (a chunk, a wavefront block) a spatially compact tile instead
    of a scanline strip: neighbouring rays see similar geometry. Pure
    host-side numpy; the only runtime cost is one gather at frame end to
    undo the permutation. Per-pixel results are unchanged (each ray's
    math is independent of its slot), so images are bit-identical to
    scanline order.
    """
    gy, gx = np.mgrid[0:h, 0:w].astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x << 8)) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << 2)) & np.uint64(0x3333333333333333)
        x = (x | (x << 1)) & np.uint64(0x5555555555555555)
        return x

    code = spread(gx) | (spread(gy) << np.uint64(1))
    perm = np.argsort(code.reshape(-1), kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm, inv


@partial(jax.jit, static_argnames=("settings",))
def render_frame(
    scene: SceneData,
    camera: Camera,
    settings: RenderSettings,
    frame: jnp.ndarray | int = 0,
) -> jnp.ndarray:
    """Render one frame: [H, W, 3] mean radiance over samples_per_pixel.

    The kernel-equivalent of HalogenCompute (compute:1015-1063): pixel grid
    -> chunked flat rays -> spp scan -> bounce scan. `frame` indexes the
    progressive-accumulation sample stream (bound like FrameCount,
    HalogenRenderPass.cs:378). Pixels are processed in ray_chunk_size
    chunks to bound live ray-state memory.
    """
    w, h = settings.width, settings.height
    n_pixels = w * h
    frame = jnp.asarray(frame, jnp.uint32)

    chunk = min(settings.ray_chunk_size, n_pixels)
    n_chunks = -(-n_pixels // chunk)
    padded = n_chunks * chunk
    perm, inv = _morton_pixel_order(w, h)
    pix = jnp.concatenate([
        jnp.asarray(perm),
        jnp.arange(n_pixels, padded, dtype=jnp.int32),
    ]) if padded > n_pixels else jnp.asarray(perm)

    def render_chunk(c, _):
        cpix = jax.lax.dynamic_slice_in_dim(pix, c * chunk, chunk)
        return c + 1, render_pixels(scene, camera, settings, frame, cpix)

    _, chunks = jax.lax.scan(
        render_chunk, jnp.int32(0), None, length=n_chunks
    )
    img = chunks.reshape(-1, 3)[:n_pixels][jnp.asarray(inv)]
    return img.reshape(h, w, 3)
