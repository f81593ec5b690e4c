"""Material evaluation: BRDF sampling + nested-dielectric bookkeeping.

Vectorized re-implementation of the reference's shading layer
(`HalgoenCompute.compute:672-817`): `material_brdf` mirrors
`material_BRDF` (diffuse lambert / metallic-fresnel specular with
roughness^2 blending / refraction with TIR), and `evaluate_material_hit`
mirrors the interface-tracking wrapper (priority-based true-hit decision,
medium stack push/pop sequencing incl. the reflected-ray "bandaid" pop at
compute:799-802, Beer-Lambert absorption at compute:810-813).

All branches are computed for every ray and combined with masks — the
whole-array equivalent of the reference's SIMT divergence.

Bounce type encoding (compute:882-887): 0 diffuse, 1 specular/glossy,
2 transmissive.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from halogen_tpu.core.math import (
    OFFSET_EPS,
    gather_rows,
    lambertian_scatter,
    lerp,
    normalize,
    reflect,
    refract,
    schlick_adjusted_specular,
)
from halogen_tpu.core.medium import Medium, MediumStack
from halogen_tpu.core.types import HitRecord, MaterialTable
from halogen_tpu.sampler.mappings import unit_vector_from_2d


class MaterialSample(NamedTuple):
    """Per-ray gathered material parameters."""

    albedo: jnp.ndarray  # [N, 3]
    alpha: jnp.ndarray  # [N] opacity
    specular: jnp.ndarray  # [N, 3]
    metallic: jnp.ndarray  # [N]
    roughness: jnp.ndarray  # [N]
    emissive_rgb: jnp.ndarray  # [N, 3]
    emissive_intensity: jnp.ndarray  # [N]
    ior: jnp.ndarray  # [N]
    absorption: jnp.ndarray  # [N, 3]
    priority: jnp.ndarray  # [N] int32
    material_id: jnp.ndarray  # [N] int32

    def internal_medium(self) -> Medium:
        """The medium inside the material (HalogenMaterial.internalMedium,
        compute:101-102)."""
        return Medium(
            ior=self.ior,
            absorption=self.absorption,
            priority=self.priority,
            material_id=self.material_id,
        )


def gather_materials(materials: MaterialTable, idx: jnp.ndarray) -> MaterialSample:
    """Fetch per-ray material parameters.

    All float fields are concatenated into one [K, 18] matrix and fetched
    with a single row gather (`gather_rows`): one contiguous 72-byte row
    per ray instead of eight scattered loads. `gather_rows` transposes
    into a dense [K, 18] reduction (no scatter), which is what the
    inverse-rendering gradient wants.
    """
    k = materials.count
    table = jnp.concatenate(
        [
            materials.albedo,                              # 0:4  rgb + alpha
            materials.specular,                            # 4:7
            materials.metallic[:, None],                   # 7
            materials.roughness[:, None],                  # 8
            materials.emissive,                            # 9:13 rgb + intensity
            materials.ior[:, None],                        # 13
            materials.absorption,                          # 14:17
            materials.priority.astype(jnp.float32)[:, None],  # 17 (small ints)
        ],
        axis=1,
    )  # [K, 18]
    row = gather_rows(table, idx)
    return MaterialSample(
        albedo=row[..., 0:3],
        alpha=row[..., 3],
        specular=row[..., 4:7],
        metallic=row[..., 7],
        roughness=row[..., 8],
        emissive_rgb=row[..., 9:12],
        emissive_intensity=row[..., 12],
        ior=row[..., 13],
        absorption=row[..., 14:17],
        priority=jnp.round(row[..., 17]).astype(jnp.int32),
        material_id=idx.astype(jnp.int32),
    )


class ScatTuple(NamedTuple):
    origin: jnp.ndarray  # [N, 3]
    direction: jnp.ndarray  # [N, 3]
    attenuation: jnp.ndarray  # [N, 3]
    bounce_type: jnp.ndarray  # [N] int32 (0 diffuse / 1 specular / 2 transmissive)
    spec_prob: jnp.ndarray  # [N] lobe-selection probability (for NEE/MIS)


def material_brdf(
    ray_dir: jnp.ndarray,
    hit: HitRecord,
    mat: MaterialSample,
    current_ior: jnp.ndarray,
    hit_ior: jnp.ndarray,
    reflection_rand: tuple[jnp.ndarray, jnp.ndarray],
    property_rand: tuple[jnp.ndarray, jnp.ndarray],
) -> ScatTuple:
    """Sample the scatter direction and attenuation (material_BRDF,
    compute:672-741). Both the reflective and refractive branches are
    evaluated; masks select.
    """
    rough_vec = unit_vector_from_2d(*reflection_rand)
    do_refraction = property_rand[0] > mat.alpha  # compute:683
    spec_rand = property_rand[1]
    normal = hit.normal
    r2 = (mat.roughness * mat.roughness)[:, None]  # perceptual roughness^2

    diffuse_dir = lambertian_scatter(normal, rough_vec)

    # --- reflective branch (compute:686-710)
    spec_prob = jnp.where(
        mat.metallic > 0.0,
        schlick_adjusted_specular(
            current_ior, hit_ior, normal, ray_dir, mat.metallic, 1.0
        ),
        mat.metallic,
    )
    do_spec = spec_rand < spec_prob
    spec_dir = lerp(reflect(ray_dir, normal), diffuse_dir, r2)
    refl_dir = jnp.where(do_spec[:, None], spec_dir, diffuse_dir)
    refl_atten = jnp.where(do_spec[:, None], mat.specular, mat.albedo)
    refl_origin = hit.pos + normal * OFFSET_EPS

    # --- refractive branch (compute:711-734)
    refr_dir, tir = refract(ray_dir, normal, current_ior, hit_ior)
    diffuse_refr_dir = lambertian_scatter(
        jnp.where(tir[:, None], normal, -normal), rough_vec
    )
    refr_dir = lerp(refr_dir, diffuse_refr_dir, r2)
    refr_origin = hit.pos - normal * OFFSET_EPS

    dm = do_refraction[:, None]
    direction = normalize(jnp.where(dm, refr_dir, refl_dir), eps=1e-20)
    origin = jnp.where(dm, refr_origin, refl_origin)
    attenuation = jnp.where(dm, jnp.ones_like(refl_atten), refl_atten)
    bounce_type = jnp.where(
        do_refraction, 2, jnp.where(do_spec, 1, 0)
    ).astype(jnp.int32)
    return ScatTuple(origin, direction, attenuation, bounce_type, spec_prob)


class ShadeResult(NamedTuple):
    origin: jnp.ndarray
    direction: jnp.ndarray
    attenuation: jnp.ndarray  # [N, 3] including absorption
    bounce_type: jnp.ndarray  # [N] int32
    stack: MediumStack
    spec_prob: jnp.ndarray  # [N] reflective-branch lobe-selection prob


def evaluate_material_hit(
    ray_dir: jnp.ndarray,
    hit: HitRecord,
    mat: MaterialSample,
    stack: MediumStack,
    active: jnp.ndarray,
    reflection_rand,
    property_rand,
    any_transmissive: bool = True,
) -> ShadeResult:
    """Interface tracking + BRDF dispatch (evaluate_material_hit,
    compute:743-817), vectorized with `active` masking all stack mutations.

    `any_transmissive=False` (static, from SceneData) takes a fast path:
    with every material opaque (alpha = 1), no lane ever refracts, every
    push is bandaid-popped within the same bounce, and the stack is
    provably empty forever — so cur/hit media collapse to
    (empty, internal) by orientation and all stack ops drop out
    (~10% of a profiled Cornell frame).
    """
    if not any_transmissive:
        return _evaluate_material_hit_opaque(
            ray_dir, hit, mat, stack, active, reflection_rand, property_rand
        )
    internal = mat.internal_medium()
    uses_tracking = mat.priority >= 0  # compute:758
    entering = hit.orientation > 0

    top0 = stack.top()
    true_hit = jnp.where(
        uses_tracking, stack.is_true_hit(mat.priority), True
    )

    # current/hit media per the four cases (compute:752-789)
    # tracking & entering: cur = top, hitm = internal
    # tracking & exiting: cur = (empty-stack ? internal : top);
    #                     pop(id); hitm = new top
    # plain & entering: cur = top, hitm = internal
    # plain & exiting: cur = internal, hitm = top
    empty0 = stack.size == 0
    track_exit = active & uses_tracking & (~entering)
    stack_after_pop = stack.pop_id(mat.material_id, track_exit)
    top_after_pop = stack_after_pop.top()

    def sel_medium(cond, a: Medium, b: Medium) -> Medium:
        c = cond[:, None]
        return Medium(
            ior=jnp.where(cond, a.ior, b.ior),
            absorption=jnp.where(c, a.absorption, b.absorption),
            priority=jnp.where(cond, a.priority, b.priority),
            material_id=jnp.where(cond, a.material_id, b.material_id),
        )

    cur = sel_medium(
        entering,
        top0,  # entering (both tracked and plain)
        sel_medium(
            uses_tracking,
            sel_medium(empty0, internal, top0),  # tracked exit
            internal,  # plain exit
        ),
    )
    hitm = sel_medium(
        entering,
        internal,
        sel_medium(uses_tracking, top_after_pop, top0),
    )

    # Stack after the pre-BRDF mutations: tracked entry pushes the internal
    # medium (compute:767); tracked exit popped above.
    track_enter = active & uses_tracking & entering
    stack1 = stack_after_pop.push(internal, track_enter)

    # --- BRDF for true hits ------------------------------------------------
    scat = material_brdf(
        ray_dir, hit, mat, cur.ior, hitm.ior, reflection_rand, property_rand
    )

    # False hit: pass through, origin shifted behind the surface, counts as
    # a transmissive bounce (compute:803-808)
    is_true = active & true_hit
    passthrough_origin = hit.pos - hit.normal * OFFSET_EPS
    origin = jnp.where(is_true[:, None], scat.origin, passthrough_origin)
    direction = jnp.where(is_true[:, None], scat.direction, ray_dir)
    attenuation = jnp.where(is_true[:, None], scat.attenuation, 1.0)
    bounce_type = jnp.where(is_true, scat.bounce_type, 2).astype(jnp.int32)

    # Bandaid pop (compute:799-802): entering rays that did NOT refract
    # leave the just-pushed medium again. Applied only on true hits.
    bandaid = is_true & entering & (bounce_type != 2)
    stack2 = stack1.pop_id(mat.material_id, bandaid)

    # Beer-Lambert absorption through the current medium (compute:810-813).
    # Miss lanes carry t = inf; pin them to 0 so 0*inf NaNs can't leak into
    # forward values or cotangents (the where() alone does not stop that).
    absorbing = cur.material_id != -1
    t_safe = jnp.where(jnp.isfinite(hit.t), hit.t, 0.0)
    absorb = jnp.exp(-cur.absorption * t_safe[:, None])
    attenuation = jnp.where(
        (active & absorbing)[:, None], attenuation * absorb, attenuation
    )

    return ShadeResult(origin, direction, attenuation, bounce_type, stack2,
                       scat.spec_prob)


def _evaluate_material_hit_opaque(
    ray_dir, hit, mat, stack, active, reflection_rand, property_rand,
) -> ShadeResult:
    """Opaque-scene specialization (see evaluate_material_hit): stack is
    always empty, every hit is a true hit, so cur/hit media reduce to
    (empty|internal) by hit orientation — identical outputs, no stack ops."""
    entering = hit.orientation > 0
    cur_ior = jnp.where(entering, jnp.float32(1.0), mat.ior)
    hit_ior = jnp.where(entering, mat.ior, jnp.float32(1.0))

    scat = material_brdf(
        ray_dir, hit, mat, cur_ior, hit_ior, reflection_rand, property_rand
    )

    # Beer-Lambert while travelling inside the material (exiting lanes):
    # cur = internal medium there, exactly as in the general path.
    t_safe = jnp.where(jnp.isfinite(hit.t), hit.t, 0.0)
    absorb = jnp.exp(-mat.absorption * t_safe[:, None])
    attenuation = jnp.where(
        (active & (~entering))[:, None], scat.attenuation * absorb,
        scat.attenuation,
    )
    return ShadeResult(scat.origin, scat.direction, attenuation,
                       scat.bounce_type, stack, scat.spec_prob)
