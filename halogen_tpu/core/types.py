"""Device-side scene pytrees (SoA, flat buffers).

The JAX analog of the reference's packed GPU structs and flat ComputeBuffers
(`Render Features/HalogenRenderPass.cs:10-76,448-509`): triangles, BVH nodes,
meshes, spheres, and materials concatenated into structure-of-array jnp
buffers with per-mesh offsets. SoA layout shards/replicates cleanly across a
device mesh and vectorizes as whole-array ops.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

NO_MEDIUM_ID = -1  # empty-medium materialID (HalgoenCompute.compute:84)
EMPTY_PRIORITY = 2**31 - 1  # empty-medium priority ~ +inf (compute:85)


def _register(cls, meta=()):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f for f in fields if f not in meta],
        meta_fields=list(meta),
    )
    return cls


@_register
@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Deduplicated material buffer (PackedHalogenMaterial,
    HalogenRenderPass.cs:44-55,425-446). All fields [K, ...] float32/int32.

    `absorption` is pre-packed as (1/subsurfaceColor) * absorption
    (HalogenRenderPass.cs:436); `emissive` stores rgb + intensity in w.
    These arrays are the primary differentiable parameters.
    """

    albedo: jnp.ndarray  # [K, 4] rgb + transmission alpha
    specular: jnp.ndarray  # [K, 3]
    metallic: jnp.ndarray  # [K]
    roughness: jnp.ndarray  # [K]
    emissive: jnp.ndarray  # [K, 4] rgb + intensity
    ior: jnp.ndarray  # [K]
    absorption: jnp.ndarray  # [K, 3] packed Beer-Lambert coefficients
    priority: jnp.ndarray  # [K] int32 dielectric priority (<0: no tracking)

    @property
    def count(self) -> int:
        return self.albedo.shape[0]


@functools.partial(_register, meta=("any_transmissive",))
@dataclasses.dataclass(frozen=True)
class SceneData:
    """Flattened render-ready scene.

    World-space triangle copies serve the gather-free brute-force
    intersector; local-space copies + per-mesh transforms serve BVH
    traversal with the reference's unnormalized-local-ray trick
    (HalgoenCompute.compute:390-392).
    """

    # Triangles, world space (pre-transformed at build): [T, 3, 3]
    tri_verts_world: jnp.ndarray
    tri_normals_world: jnp.ndarray  # inverse-transpose-transformed, unnormalized
    tri_material: jnp.ndarray  # [T] int32
    tri_mesh: jnp.ndarray  # [T] int32 owning mesh id

    # Triangles, local space (BVH path): [T, 3, 3]
    tri_verts_local: jnp.ndarray
    tri_normals_local: jnp.ndarray

    # BVH nodes, concatenated across meshes (BVHEntry,
    # HalogenRenderPass.cs:68-76): child indices are mesh-relative.
    bvh_lo: jnp.ndarray  # [B, 3]
    bvh_hi: jnp.ndarray  # [B, 3]
    bvh_index_a: jnp.ndarray  # [B] int32: first-tri (leaf) / first-child (inner)
    bvh_count: jnp.ndarray  # [B] int32: >0 leaf triangle count

    # Mesh table (HalogenMeshData, HalogenRenderPass.cs:21-34)
    mesh_tri_offset: jnp.ndarray  # [M] int32
    mesh_bvh_offset: jnp.ndarray  # [M] int32
    mesh_material: jnp.ndarray  # [M] int32
    mesh_world_to_local: jnp.ndarray  # [M, 4, 4]
    mesh_local_to_world: jnp.ndarray  # [M, 4, 4]

    # Spheres (HalogenSphere, HalogenRenderPass.cs:10-19)
    sphere_center: jnp.ndarray  # [S, 3]
    sphere_radius: jnp.ndarray  # [S]
    sphere_material: jnp.ndarray  # [S] int32

    materials: MaterialTable

    # Environment map mip pyramid (equirectangular, linear RGB), stored as a
    # tuple of [Hm, Wm, 3] levels, coarsest-last. Empty tuple = black sky.
    env_mips: Tuple[jnp.ndarray, ...] = ()

    # Envmap luminance-CDF tables (scene/envmap.EnvCDF) for next-event
    # estimation + MIS, or None (capability beyond the reference).
    env_cdf: object = None

    # Emissive-triangle table (scene/lights.LightTable) for area-light
    # next-event estimation + MIS, or None (capability beyond the
    # reference). tri_light_pdf_area is the dense per-triangle companion:
    # selection_prob/area for emissive triangles, 0 elsewhere.
    lights: object = None
    tri_light_pdf_area: jnp.ndarray = None
    sphere_light_sel: jnp.ndarray = None  # [S] selection prob, 0 non-emissive

    # Static (jit-specializing) scene facts, computed at build time.
    # `any_transmissive`: does any material have transmission alpha < 1?
    # When False the nested-dielectric stack is provably always empty and
    # the integrator skips the per-bounce stack machinery entirely.
    any_transmissive: bool = True

    @property
    def num_triangles(self) -> int:
        return self.tri_verts_world.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def num_meshes(self) -> int:
        return self.mesh_tri_offset.shape[0]


@_register
@dataclasses.dataclass(frozen=True)
class HitRecord:
    """SoA batch of resolved closest hits (RayHit,
    HalgoenCompute.compute:156-164)."""

    t: jnp.ndarray  # [N] distance, +inf on miss
    pos: jnp.ndarray  # [N, 3]
    normal: jnp.ndarray  # [N, 3] shading normal, flipped double-sided
    orientation: jnp.ndarray  # [N] +1 front / -1 back
    material: jnp.ndarray  # [N] int32 material index
    tri: jnp.ndarray  # [N] int32 global triangle index, -1 for sphere/miss
    sphere: jnp.ndarray  # [N] int32 sphere index, -1 for triangle/miss
