"""Scene intersection backends.

Two whole-array JAX formulations of the reference's intersection layer
(`HalgoenCompute.compute:244-485`):

- **Brute-force** (`intersect_brute`): rays x triangle-blocks on
  world-space pre-transformed triangles. Completely regular — no gathers,
  no per-ray control flow; a `lax.scan` over triangle tiles with a
  running min. Used for small (Cornell-class) scenes. Spheres are tested
  in one vectorized pass (the reference also linear-scans spheres,
  compute:357-376).

- **BVH traversal** (`intersect_bvh`): the semantics oracle of the
  reference's per-mesh stack traversal (compute:378-472) — local-space
  unnormalized rays (world-t preservation trick, compute:390-392),
  fixed-depth stacks, nearest-child-first descent, leaf triangle tests —
  vectorized over all rays in lockstep with per-ray masks, in a
  `lax.while_loop` that runs until the last ray's stack is empty. Used
  for triangle counts beyond the brute-force threshold.

Both return an identical `HitRecord` plus (triangle_tests, box_tests)
counters for the debug heatmaps (compute:192-193).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from halogen_tpu.config import Intersector, RenderSettings
from halogen_tpu.core.math import (
    HIT_EPS,
    INF,
    gather_rows,
    normalize,
    ray_aabb_soa,
    sphere_intersect_soa,
    transform_dir,
    transform_normal,
    transform_point,
    triangle_intersect_soa,
    unstack3,
)
from halogen_tpu.core.types import HitRecord, SceneData

STACK_DEPTH = 32  # NodeStack[32] (HalgoenCompute.compute:397)


def _safe_inv(d: jnp.ndarray) -> jnp.ndarray:
    """1/dir with zero components clamped so the slab test stays NaN-free
    (the reference relies on HLSL min/max NaN behavior; we avoid NaNs)."""
    tiny = np.float32(1e-30)
    return 1.0 / jnp.where(jnp.abs(d) < tiny, tiny, d)


# ---------------------------------------------------------------------------
# Brute force
# ---------------------------------------------------------------------------

def intersect_tris_brute(
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    tri_verts: jnp.ndarray,
    block: int = 128,
):
    """Closest-hit over all triangles, tiled in `block`-sized lanes.

    Returns (t [N], tri_index [N], u [N], v [N], orientation [N]); misses
    have t = +inf. Triangle tests per ray = padded triangle count.
    """
    n = origin.shape[0]
    t_count = tri_verts.shape[0]
    if t_count == 0:
        z = jnp.zeros((n,), jnp.float32)
        return jnp.full((n,), INF), jnp.zeros((n,), jnp.int32), z, z, z

    # Triangle tiles are oriented [B, N] (triangles x rays), and a scene
    # with T < block triangles pads T only up to the next multiple of 8,
    # not to a whole block: a 12-triangle Cornell box tests 16, not 128.
    sub = 8
    blk = max(sub, min(block, -(-t_count // sub) * sub))
    pad = (-t_count) % blk
    if pad:
        tri_verts = jnp.concatenate(
            [tri_verts, jnp.zeros((pad, 3, 3), tri_verts.dtype)], axis=0
        )  # degenerate pads have det 0 -> always miss
    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    comps = jnp.concatenate([v0, e1, e2], axis=1)  # [T, 9]
    blocks = comps.reshape(-1, blk, 9).transpose(0, 2, 1)  # [nb, 9, B]

    o = tuple(origin[None, :, k] for k in range(3))  # [1, N] components
    d = tuple(direction[None, :, k] for k in range(3))

    def body(carry, inp):
        base, rows = inp  # rows: [9, B]
        best_t, best_i = carry
        t, _, _, _ = triangle_intersect_soa(
            o, d,
            (rows[0][:, None], rows[1][:, None], rows[2][:, None]),
            (rows[3][:, None], rows[4][:, None], rows[5][:, None]),
            (rows[6][:, None], rows[7][:, None], rows[8][:, None]),
        )  # [B, N]
        t = jnp.where(t > HIT_EPS, t, INF)
        blk_t = jnp.min(t, axis=0)
        arg = jnp.argmin(t, axis=0)
        better = blk_t < best_t
        idx = base + arg.astype(jnp.int32)
        return (jnp.where(better, blk_t, best_t),
                jnp.where(better, idx, best_i)), None

    bases = jnp.arange(blocks.shape[0], dtype=jnp.int32) * blk
    init = (jnp.full((n,), INF), jnp.zeros((n,), jnp.int32))
    if blocks.shape[0] == 1:
        (best_t, best_i), _ = body(init, (bases[0], blocks[0]))
    else:
        (best_t, best_i), _ = jax.lax.scan(body, init, (bases, blocks))

    # Recompute (u, v, orientation) for the single winning triangle per ray:
    # a one-hot/dynamic row fetch of its 9 components + one [N]-shaped
    # Möller-Trumbore — far cheaper than payload-carrying reductions.
    win = gather_rows(comps, best_i)  # [N, 9]
    _, best_u, best_v, best_s = triangle_intersect_soa(
        (origin[:, 0], origin[:, 1], origin[:, 2]),
        (direction[:, 0], direction[:, 1], direction[:, 2]),
        (win[:, 0], win[:, 1], win[:, 2]),
        (win[:, 3], win[:, 4], win[:, 5]),
        (win[:, 6], win[:, 7], win[:, 8]),
    )
    miss = best_t >= INF
    best_u = jnp.where(miss, 0.0, best_u)
    best_v = jnp.where(miss, 0.0, best_v)
    best_s = jnp.where(miss, 0.0, best_s)
    return best_t, best_i, best_u, best_v, best_s


def _intersect_spheres(scene: SceneData, origin, direction, far):
    """Vectorized sphere pass (get_ray_scene_intersection_sphere,
    compute:357-376): AABB pre-test against the far plane, then the
    quadratic, keeping the closest t > eps."""
    n = origin.shape[0]
    s = scene.num_spheres
    if s == 0:
        return (jnp.full((n,), INF), jnp.zeros((n,), jnp.int32),
                jnp.ones((n,), jnp.float32))
    # SoA components oriented [S, N] (spheres x rays), as the triangle
    # tiles of intersect_tris_brute.
    o = tuple(origin[None, :, k] for k in range(3))
    d = tuple(direction[None, :, k] for k in range(3))
    inv_dv = _safe_inv(direction)
    inv_d = tuple(inv_dv[None, :, k] for k in range(3))
    c = tuple(scene.sphere_center[:, k][:, None] for k in range(3))
    r = scene.sphere_radius[:, None]
    lo = tuple(ck - r for ck in c)
    hi = tuple(ck + r for ck in c)
    aabb_t = ray_aabb_soa(lo, hi, o, inv_d)  # [S, N]
    t, orient = sphere_intersect_soa(o, d, c, r)  # [S, N]
    t = jnp.where((aabb_t < far[None, :]) & (t > HIT_EPS), t, INF)
    best_t = jnp.min(t, axis=0)
    arg = jnp.argmin(t, axis=0).astype(jnp.int32)
    # Winner orientation via a [S, N] one-hot select (S is tiny).
    sel = jax.lax.broadcasted_iota(jnp.int32, t.shape, 0) == arg[None, :]
    best_orient = jnp.sum(jnp.where(sel, orient, 0.0), axis=0)
    return best_t, arg, best_orient


def _hit_pos(origin, direction, t):
    """origin + direction * t with miss lanes (t = inf) pinned to the
    origin — keeps inf/NaN out of downstream buffers and gradients."""
    t_safe = jnp.where(jnp.isfinite(t), t, 0.0)
    return origin + direction * t_safe[..., None]


def _sphere_normal_material(scene, pos, sp_i, sp_orient):
    """Sphere shading normal + material, safe for sphere-less scenes."""
    if scene.num_spheres == 0:
        return jnp.zeros_like(pos), jnp.zeros_like(sp_i)
    normal = normalize(
        (pos - gather_rows(scene.sphere_center, sp_i)) * sp_orient[:, None],
        eps=1e-20,
    )
    return normal, gather_rows(scene.sphere_material, sp_i)


def _sphere_only_hit(scene, origin, direction, sp_t, sp_i, sp_orient):
    pos = _hit_pos(origin, direction, sp_t)
    normal, material = _sphere_normal_material(scene, pos, sp_i, sp_orient)
    sp_hit = sp_t < INF
    return HitRecord(t=sp_t, pos=pos, normal=normal,
                     orientation=sp_orient, material=material,
                     tri=jnp.full(sp_t.shape, -1, jnp.int32),
                     sphere=jnp.where(sp_hit, sp_i, -1))


def intersect_brute(
    scene: SceneData, origin: jnp.ndarray, direction: jnp.ndarray,
    far: jnp.ndarray, block: int = 128,
):
    """Full-scene brute-force closest hit -> (HitRecord, tri_tests, box_tests)."""
    n = origin.shape[0]
    sp_t, sp_i, sp_orient = _intersect_spheres(scene, origin, direction, far)
    if scene.num_triangles == 0:
        hit = _sphere_only_hit(scene, origin, direction, sp_t, sp_i, sp_orient)
        zeros = jnp.zeros((n,), jnp.int32)
        return hit, zeros, zeros

    tr_t, tr_i, tr_u, tr_v, tr_s = intersect_tris_brute(
        origin, direction, scene.tri_verts_world, block
    )
    # Mesh hit must beat the sphere hit by epsilon and lie inside the far
    # plane (compute:452).
    mesh_wins = (tr_t < sp_t - HIT_EPS) & (tr_t < far)

    t = jnp.where(mesh_wins, tr_t, sp_t)
    pos = _hit_pos(origin, direction, t)

    # Triangle shading normal (compute:462-467), world-space inputs
    tri_n = gather_rows(scene.tri_normals_world, tr_i)  # [N, 3, 3]
    n0, n1, n2 = tri_n[:, 0], tri_n[:, 1], tri_n[:, 2]
    tri_normal = n0 + (n1 - n0) * tr_u[:, None] + (n2 - n0) * tr_v[:, None]
    tri_normal = normalize(
        tri_normal * tr_s[:, None], eps=1e-20
    )

    sph_normal, sph_material = _sphere_normal_material(scene, pos, sp_i, sp_orient)

    normal = jnp.where(mesh_wins[:, None], tri_normal, sph_normal)
    orientation = jnp.where(mesh_wins, tr_s, sp_orient)
    material = jnp.where(
        mesh_wins, gather_rows(scene.tri_material, tr_i), sph_material
    )

    hit = HitRecord(t=t, pos=pos, normal=normal,
                    orientation=orientation, material=material,
                    tri=jnp.where(mesh_wins, tr_i, -1),
                    sphere=jnp.where((~mesh_wins) & (sp_t < INF), sp_i, -1))
    tri_tests = jnp.full((n,), scene.num_triangles, jnp.int32)
    box_tests = jnp.zeros((n,), jnp.int32)
    return hit, tri_tests, box_tests


# ---------------------------------------------------------------------------
# BVH traversal
# ---------------------------------------------------------------------------

def _stack_read(stack: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """stack [N, D] read at per-row idx [N] via one-hot (no gather)."""
    sel = (
        jax.lax.broadcasted_iota(jnp.int32, stack.shape, 1) == idx[:, None]
    )
    return jnp.sum(jnp.where(sel, stack, 0), axis=1)


def _stack_write(stack: jnp.ndarray, idx: jnp.ndarray, value: jnp.ndarray,
                 mask: jnp.ndarray) -> jnp.ndarray:
    sel = (
        jax.lax.broadcasted_iota(jnp.int32, stack.shape, 1) == idx[:, None]
    ) & mask[:, None]
    return jnp.where(sel, value[:, None], stack)


def intersect_bvh(
    scene: SceneData, origin: jnp.ndarray, direction: jnp.ndarray,
    far: jnp.ndarray, max_leaf: int = 5,
):
    """Per-mesh stack-based BVH traversal over all rays in lockstep
    (get_ray_scene_intersection_mesh, compute:378-472).

    All rays traverse each mesh's tree together; each ray carries its own
    32-deep node stack, popped/pushed under masks. The loop runs until every
    ray's stack empties. Returns (HitRecord, tri_tests, box_tests).
    """
    n = origin.shape[0]
    sp_t, sp_i, sp_orient = _intersect_spheres(scene, origin, direction, far)
    if scene.num_triangles == 0 or scene.num_meshes == 0:
        hit = _sphere_only_hit(scene, origin, direction, sp_t, sp_i, sp_orient)
        zeros = jnp.zeros((n,), jnp.int32)
        return hit, zeros, zeros

    best = dict(
        t=jnp.full((n,), INF),
        tri=jnp.zeros((n,), jnp.int32),
        u=jnp.zeros((n,), jnp.float32),
        v=jnp.zeros((n,), jnp.float32),
        s=jnp.zeros((n,), jnp.float32),
        mesh=jnp.zeros((n,), jnp.int32),
    )
    tri_tests = jnp.zeros((n,), jnp.int32)
    box_tests = jnp.zeros((n,), jnp.int32)

    num_meshes = scene.num_meshes
    # Seed the running closest-t with the sphere result (the reference
    # traverses with closestHit.rayT already holding the sphere distance).
    best["t"] = jnp.where(sp_t < INF, sp_t, best["t"])
    sphere_seeded_t = best["t"]

    def mesh_body(mi, carry):
        best, tri_tests, box_tests = carry
        w2l = scene.mesh_world_to_local[mi]
        tri_off = scene.mesh_tri_offset[mi]
        bvh_off = scene.mesh_bvh_offset[mi]

        # Local-space ray, deliberately unnormalized so t stays world-scale
        # (compute:390-395)
        lo_o = transform_point(w2l[None], origin)
        lo_d = transform_dir(w2l[None], direction)
        inv_d = _safe_inv(lo_d)
        # Component tuples ([N] each) for the SoA hot loop below.
        lo_oc = unstack3(lo_o)
        lo_dc = unstack3(lo_d)
        inv_dc = unstack3(inv_d)

        stack = jnp.zeros((n, STACK_DEPTH), jnp.int32)
        sp = jnp.ones((n,), jnp.int32)  # root (node 0, mesh-relative) pushed

        def cond(state):
            _, sp, *_ = state
            return jnp.any(sp > 0)

        def body(state):
            stack, sp, best, tri_tests, box_tests = state
            active = sp > 0
            node = _stack_read(stack, jnp.maximum(sp - 1, 0))
            sp = jnp.where(active, sp - 1, sp)
            g = bvh_off + node
            count = scene.bvh_count[g]
            index_a = scene.bvh_index_a[g]
            is_leaf = active & (count > 0)
            is_inner = active & (count == 0)

            # ---- leaf: test up to max_leaf triangles (compute:407-421)
            new_best = dict(best)
            for k in range(max_leaf):
                tk = tri_off + index_a + k
                do = is_leaf & (k < count)
                tv = scene.tri_verts_local[jnp.where(do, tk, 0)]
                v0 = tv[:, 0]
                t, u, v, s = triangle_intersect_soa(
                    lo_oc, lo_dc, unstack3(v0),
                    unstack3(tv[:, 1] - v0), unstack3(tv[:, 2] - v0),
                )
                ok = do & (t > HIT_EPS) & (t < new_best["t"])
                new_best = dict(
                    t=jnp.where(ok, t, new_best["t"]),
                    tri=jnp.where(ok, tk, new_best["tri"]),
                    u=jnp.where(ok, u, new_best["u"]),
                    v=jnp.where(ok, v, new_best["v"]),
                    s=jnp.where(ok, s, new_best["s"]),
                    mesh=jnp.where(ok, mi, new_best["mesh"]),
                )
            tri_tests = tri_tests + jnp.where(
                is_leaf, jnp.minimum(count, max_leaf), 0
            )

            # ---- inner: ordered near-first descent (compute:422-444)
            ca = bvh_off + index_a
            cb = ca + 1
            ca_s = jnp.where(is_inner, ca, 0)
            cb_s = jnp.where(is_inner, cb, 0)
            da = ray_aabb_soa(unstack3(scene.bvh_lo[ca_s]),
                              unstack3(scene.bvh_hi[ca_s]), lo_oc, inv_dc)
            db = ray_aabb_soa(unstack3(scene.bvh_lo[cb_s]),
                              unstack3(scene.bvh_hi[cb_s]), lo_oc, inv_dc)
            box_tests = box_tests + jnp.where(is_inner, 2, 0)

            t_lim = new_best["t"]
            a_first = da <= db  # push far child first so near pops first
            far_node = jnp.where(a_first, index_a + 1, index_a)
            near_node = jnp.where(a_first, index_a, index_a + 1)
            far_d = jnp.maximum(da, db)
            near_d = jnp.minimum(da, db)

            push_far = is_inner & (far_d < t_lim) & (sp < STACK_DEPTH)
            stack = _stack_write(stack, sp, far_node, push_far)
            sp = sp + push_far.astype(jnp.int32)
            push_near = is_inner & (near_d < t_lim) & (sp < STACK_DEPTH)
            stack = _stack_write(stack, sp, near_node, push_near)
            sp = sp + push_near.astype(jnp.int32)

            return (stack, sp, new_best, tri_tests, box_tests)

        _, _, best, tri_tests, box_tests = jax.lax.while_loop(
            cond, body, (stack, sp, best, tri_tests, box_tests)
        )
        return (best, tri_tests, box_tests)

    best, tri_tests, box_tests = jax.lax.fori_loop(
        0, num_meshes, mesh_body, (best, tri_tests, box_tests)
    )

    # ---- resolve winner: a triangle must beat the sphere hit by epsilon
    # and lie inside the far plane (compute:452)
    mesh_wins = (best["t"] < sphere_seeded_t - HIT_EPS) & (best["t"] < far)
    t = jnp.where(mesh_wins, best["t"], sp_t)
    pos = _hit_pos(origin, direction, t)

    tri_n = gather_rows(scene.tri_normals_local, best["tri"])
    n0, n1, n2 = tri_n[:, 0], tri_n[:, 1], tri_n[:, 2]
    nrm = n0 + (n1 - n0) * best["u"][:, None] + (n2 - n0) * best["v"][:, None]
    nrm = nrm * best["s"][:, None]
    w2l = gather_rows(scene.mesh_world_to_local, best["mesh"])
    tri_normal = normalize(transform_normal(w2l, nrm), eps=1e-20)

    sph_normal, sph_material = _sphere_normal_material(scene, pos, sp_i, sp_orient)
    normal = jnp.where(mesh_wins[:, None], tri_normal, sph_normal)
    orientation = jnp.where(mesh_wins, best["s"], sp_orient)
    material = jnp.where(
        mesh_wins, gather_rows(scene.mesh_material, best["mesh"]), sph_material
    )
    hit = HitRecord(t=t, pos=pos, normal=normal,
                    orientation=orientation, material=material,
                    tri=jnp.where(mesh_wins, best["tri"], -1),
                    sphere=jnp.where((~mesh_wins) & (sp_t < INF), sp_i, -1))
    return hit, tri_tests, box_tests


def intersect_scene(
    scene: SceneData, origin: jnp.ndarray, direction: jnp.ndarray,
    far: jnp.ndarray, settings: RenderSettings,
):
    """Backend dispatch (static): AUTO uses brute force up to
    `brute_force_max_tris` triangles and the lockstep BVH traversal above
    it (get_ray_intersection, compute:474-485). The choice depends on the
    scene alone, never on the platform."""
    kind = settings.intersector
    if kind == Intersector.AUTO:
        kind = (Intersector.BRUTE
                if scene.num_triangles <= settings.brute_force_max_tris
                else Intersector.BVH)
    if kind == Intersector.BRUTE:
        return intersect_brute(scene, origin, direction, far,
                               settings.triangle_block)
    return intersect_bvh(scene, origin, direction, far)
