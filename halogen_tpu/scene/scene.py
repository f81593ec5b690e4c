"""Scene registry and device-buffer packing.

Host-side counterpart of the reference's scene registry + render-pass buffer
packing (`RayTracingManager.cs:40-145`, `HalogenRenderPass.cs:448-509`):
spheres and meshes are registered with materials, then `build()` flattens
everything into the SoA `SceneData` pytree — materials deduplicated by value
(`PackMaterialToList`, HalogenRenderPass.cs:524-537), triangles and BVH
nodes concatenated with per-mesh offsets, and world-space triangle copies
pre-transformed for the gather-free brute-force intersector.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from halogen_tpu.accel.bvh import BVH, build_bvh, MAX_DEPTH, MAX_LEAF_TRIS
from halogen_tpu.core.types import MaterialTable, SceneData
from halogen_tpu.scene.material import Material


@dataclasses.dataclass
class MeshEntry:
    tri_verts: np.ndarray  # [T, 3, 3] local space
    tri_normals: np.ndarray  # [T, 3, 3] local space
    transform: np.ndarray  # [4, 4] local->world
    material: Material
    max_depth: int = MAX_DEPTH
    bvh: Optional[BVH] = None


@dataclasses.dataclass
class SphereEntry:
    center: np.ndarray
    radius: float
    material: Material


class Scene:
    """Mutable scene description; `build()` produces the immutable device
    pytree consumed by the integrator."""

    def __init__(self):
        self.meshes: List[MeshEntry] = []
        self.spheres: List[SphereEntry] = []

    # -- registration (RayTracingManager.AddTo*List analogs) ------------
    def add_sphere(self, center, radius: float, material: Material) -> int:
        self.spheres.append(
            SphereEntry(np.asarray(center, np.float32), float(radius), material)
        )
        return len(self.spheres) - 1

    def add_mesh(
        self,
        vertices: np.ndarray,
        indices: np.ndarray,
        material: Material,
        normals: Optional[np.ndarray] = None,
        transform: Optional[np.ndarray] = None,
        max_depth: int = MAX_DEPTH,
    ) -> int:
        """Register a triangle mesh.

        vertices [V, 3], indices [F, 3] (or flat [3F]), optional per-vertex
        normals [V, 3] (default: area-weighted face-accumulated vertex
        normals), optional [4, 4] local->world transform.
        """
        vertices = np.asarray(vertices, np.float32)
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        if normals is None:
            normals = _vertex_normals(vertices, indices)
        else:
            normals = np.asarray(normals, np.float32)
        tri_verts = vertices[indices]  # [T, 3, 3]
        tri_normals = normals[indices]
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        self.meshes.append(
            MeshEntry(tri_verts, tri_normals,
                      np.asarray(transform, np.float32), material, max_depth)
        )
        return len(self.meshes) - 1

    # -- packing ---------------------------------------------------------
    def build(self, envmap: Optional[object] = None,
              max_leaf: int = MAX_LEAF_TRIS) -> SceneData:
        materials: List[Material] = []

        def material_index(m: Material) -> int:
            # Dedup by value (HalogenRenderPass.cs:524-537)
            for i, existing in enumerate(materials):
                if existing == m:
                    return i
            materials.append(m)
            return len(materials) - 1

        # Spheres
        s_center = np.zeros((len(self.spheres), 3), np.float32)
        s_radius = np.zeros((len(self.spheres),), np.float32)
        s_mat = np.zeros((len(self.spheres),), np.int32)
        for i, s in enumerate(self.spheres):
            s_center[i] = s.center
            s_radius[i] = s.radius
            s_mat[i] = material_index(s.material)

        # Meshes: build BVHs (reorders triangles), then concatenate
        tv_local, tn_local, tv_world, tn_world = [], [], [], []
        tri_mat, tri_mesh = [], []
        bvh_lo, bvh_hi, bvh_ia, bvh_ct = [], [], [], []
        m_tri_off, m_bvh_off, m_mat, m_w2l, m_l2w = [], [], [], [], []
        tri_cursor = node_cursor = 0
        for mi, m in enumerate(self.meshes):
            bvh = build_bvh(m.tri_verts.copy(), max_leaf=max_leaf,
                            max_depth=m.max_depth)
            m.bvh = bvh
            order = bvh.tri_order
            verts = m.tri_verts[order]
            norms = m.tri_normals[order]
            mat_idx = material_index(m.material)

            l2w = m.transform
            w2l = np.linalg.inv(l2w).astype(np.float32)
            # World-space copies for the brute-force path: points by L2W,
            # normals by inverse-transpose (rows of W2L), unnormalized —
            # normalization happens after barycentric interpolation, matching
            # HalgoenCompute.compute:463-467.
            vw = verts @ l2w[:3, :3].T + l2w[:3, 3]
            nw = norms @ w2l[:3, :3]

            tv_local.append(verts)
            tn_local.append(norms)
            tv_world.append(vw.astype(np.float32))
            tn_world.append(nw.astype(np.float32))
            t = verts.shape[0]
            tri_mat.append(np.full(t, mat_idx, np.int32))
            tri_mesh.append(np.full(t, mi, np.int32))

            bvh_lo.append(bvh.lo)
            bvh_hi.append(bvh.hi)
            bvh_ia.append(bvh.index_a)
            bvh_ct.append(bvh.count)

            m_tri_off.append(tri_cursor)
            m_bvh_off.append(node_cursor)
            m_mat.append(mat_idx)
            m_w2l.append(w2l)
            m_l2w.append(l2w)
            tri_cursor += t
            node_cursor += bvh.num_nodes

        def cat(parts, empty_shape, dtype=np.float32):
            if parts:
                return np.concatenate(parts).astype(dtype)
            return np.zeros(empty_shape, dtype)

        mat_table = _pack_materials(materials)

        tv_world_cat = cat(tv_world, (0, 3, 3))

        from halogen_tpu.scene.lights import build_light_table

        lights, tri_light_pdf, sphere_light_sel = build_light_table(
            tv_world_cat,
            cat(tri_mat, (0,), np.int32),
            s_center, s_radius, s_mat,
            np.asarray(mat_table.emissive),
        )

        env_mips: Tuple[jnp.ndarray, ...] = ()
        env_cdf = None
        if envmap is not None:
            from halogen_tpu.scene.envmap import Envmap, build_env_cdf

            assert isinstance(envmap, Envmap)
            env_mips = tuple(jnp.asarray(m) for m in envmap.mips)
            env_cdf = build_env_cdf(envmap.mips[0])

        return SceneData(
            tri_verts_world=jnp.asarray(tv_world_cat),
            tri_normals_world=jnp.asarray(cat(tn_world, (0, 3, 3))),
            tri_material=jnp.asarray(cat(tri_mat, (0,), np.int32)),
            tri_mesh=jnp.asarray(cat(tri_mesh, (0,), np.int32)),
            tri_verts_local=jnp.asarray(cat(tv_local, (0, 3, 3))),
            tri_normals_local=jnp.asarray(cat(tn_local, (0, 3, 3))),
            bvh_lo=jnp.asarray(cat(bvh_lo, (0, 3))),
            bvh_hi=jnp.asarray(cat(bvh_hi, (0, 3))),
            bvh_index_a=jnp.asarray(cat(bvh_ia, (0,), np.int32)),
            bvh_count=jnp.asarray(cat(bvh_ct, (0,), np.int32)),
            mesh_tri_offset=jnp.asarray(np.asarray(m_tri_off, np.int32)),
            mesh_bvh_offset=jnp.asarray(np.asarray(m_bvh_off, np.int32)),
            mesh_material=jnp.asarray(np.asarray(m_mat, np.int32)),
            mesh_world_to_local=jnp.asarray(
                np.stack(m_w2l) if m_w2l else np.zeros((0, 4, 4), np.float32)
            ),
            mesh_local_to_world=jnp.asarray(
                np.stack(m_l2w) if m_l2w else np.zeros((0, 4, 4), np.float32)
            ),
            sphere_center=jnp.asarray(s_center),
            sphere_radius=jnp.asarray(s_radius),
            sphere_material=jnp.asarray(s_mat),
            materials=mat_table,
            env_mips=env_mips,
            env_cdf=env_cdf,
            lights=lights,
            tri_light_pdf_area=jnp.asarray(tri_light_pdf),
            sphere_light_sel=jnp.asarray(sphere_light_sel),
            # Static: any material that can refract (transmission alpha < 1)?
            # False lets the integrator skip the nested-dielectric stack
            # machinery — it is provably a no-op in fully opaque scenes.
            any_transmissive=bool(
                np.asarray(mat_table.albedo)[:, 3].min(initial=1.0) < 1.0
            ),
        )


def _vertex_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for meshes without authored normals."""
    v0, v1, v2 = (vertices[indices[:, k]] for k in range(3))
    face_n = np.cross(v1 - v0, v2 - v0)  # area-weighted
    normals = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(normals, indices[:, k], face_n)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(lens, 1e-12)).astype(np.float32)


def _pack_materials(materials: List[Material]) -> MaterialTable:
    """Pack to the device table (PackHalogenMaterial,
    HalogenRenderPass.cs:425-446)."""
    k = max(len(materials), 1)
    albedo = np.zeros((k, 4), np.float32)
    specular = np.ones((k, 3), np.float32)
    metallic = np.zeros((k,), np.float32)
    roughness = np.ones((k,), np.float32)
    emissive = np.zeros((k, 4), np.float32)
    ior = np.ones((k,), np.float32)
    absorption = np.zeros((k, 3), np.float32)
    priority = np.zeros((k,), np.int32)
    for i, m in enumerate(materials):
        albedo[i, :3] = m.color
        albedo[i, 3] = m.opacity
        specular[i] = m.specular_color
        metallic[i] = m.metallic
        roughness[i] = m.roughness
        emissive[i, :3] = m.emission_color
        emissive[i, 3] = m.emission_intensity
        ior[i] = m.index_of_refraction
        absorption[i] = m.packed_absorption()
        priority[i] = m.dielectric_priority
    return MaterialTable(
        albedo=jnp.asarray(albedo),
        specular=jnp.asarray(specular),
        metallic=jnp.asarray(metallic),
        roughness=jnp.asarray(roughness),
        emissive=jnp.asarray(emissive),
        ior=jnp.asarray(ior),
        absorption=jnp.asarray(absorption),
        priority=jnp.asarray(priority),
    )
