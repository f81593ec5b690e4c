"""Vectorized geometry math for the path tracer.

Every function here is shape-polymorphic over a leading batch of rays and is
elementwise work under jit (no data-dependent control flow). These are the
JAX counterparts of the reference's HLSL intersection/shading helpers in
`Halogen Shaders/HalgoenCompute.compute` (cited per function).

A float32 `einsum`/`matmul` at default precision may run in TF32 on a GPU
(10 mantissa bits), which would put camera rays and the world-to-local
rays of the BVH walk ~1e-3 off, relative to scene scale. The 3x3
transforms below are therefore written as explicit multiply-adds; the one
matmul here (the transpose of `gather_rows`) asks for HIGHEST precision.

Convention: 3-vectors are stored in the trailing axis ([..., 3]); batched
broadcasting follows numpy rules.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

INF = np.float32(np.inf)
HIT_EPS = np.float32(1e-4)  # hitDistanceEpsilon (HalgoenCompute.compute:360,383)
OFFSET_EPS = np.float32(1e-4)  # surface offset (HalgoenCompute.compute:710,724)
DET_EPS = np.float32(1e-8)  # parallel-ray cutoff (HalgoenCompute.compute:321)


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def normalize(v: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    n = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    return v / jnp.maximum(n, eps) if eps else v / n


def transform_dir(mat: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Apply a [..., 4, 4] matrix to [..., 3] directions (w = 0):
    sum_j M[i, j] d[j], in full float32."""
    return (mat[..., :3, 0] * d[..., 0:1] + mat[..., :3, 1] * d[..., 1:2]
            + mat[..., :3, 2] * d[..., 2:3])


def transform_point(mat: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply a [..., 4, 4] affine matrix to [..., 3] points (w = 1)."""
    return transform_dir(mat, p) + mat[..., :3, 3]


def transform_normal(world_to_local: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Transform a normal by the inverse-transpose of local->world, i.e.
    n' = (W2L)^T n (HalgoenCompute.compute:467), in full float32."""
    m = world_to_local
    return (m[..., 0, :3] * n[..., 0:1] + m[..., 1, :3] * n[..., 1:2]
            + m[..., 2, :3] * n[..., 2:3])


def ray_aabb(
    lo: jnp.ndarray, hi: jnp.ndarray, origin: jnp.ndarray, inv_dir: jnp.ndarray
) -> jnp.ndarray:
    """Slab test (HalgoenCompute.compute:244-259).

    Returns entry distance tMin (which may be negative when the origin is
    inside the box — the reference keeps that semantics for its
    nearest-child traversal ordering), or +inf on miss.
    """
    t1 = (lo - origin) * inv_dir
    t2 = (hi - origin) * inv_dir
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return jnp.where(tmax > jnp.maximum(0.0, tmin), tmin, INF)


def sphere_intersect(
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    center: jnp.ndarray,
    radius: jnp.ndarray,
):
    """Quadratic sphere test (HalgoenCompute.compute:266-303).

    Returns (t, orientation): nearest positive-ish root with the reference's
    inside-sphere handling — if the near root is behind the origin the far
    root is used and orientation flips to -1 (hit from inside). t may still
    be negative (behind); callers filter with t > HIT_EPS. Misses are +inf.
    """
    oc = origin - center
    b = 2.0 * dot(oc, direction)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_near = (-b - sq) * 0.5
    t_far = (-b + sq) * 0.5
    inside = t_near < 0.0
    t = jnp.where(inside, t_far, t_near)
    orientation = jnp.where(inside, -1.0, 1.0)
    t = jnp.where(disc >= 0.0, t, INF)
    return t, orientation


def triangle_intersect(
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    v0: jnp.ndarray,
    v1: jnp.ndarray,
    v2: jnp.ndarray,
):
    """Double-sided Möller-Trumbore (HalgoenCompute.compute:307-355).

    Returns (t, u, v, orientation); t = +inf on miss, orientation =
    sign(determinant) (+1 front face, -1 back face). Barycentrics follow the
    reference's layout: the interpolated normal is
    n0 + (n1-n0)*u + (n2-n0)*v (HalgoenCompute.compute:463).
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(direction, e2)
    det = dot(pvec, e1)
    parallel = jnp.abs(det) < DET_EPS
    inv_det = 1.0 / jnp.where(parallel, 1.0, det)
    tvec = origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
    )
    t = jnp.where(valid, t, INF)
    return t, u, v, jnp.sign(det)


# ---------------------------------------------------------------------------
# SoA (component-wise) variants of the hot intersection primitives.
#
# The hot intersection loops operate on per-component arrays whose trailing
# axis is a batch dimension (rays or primitives) instead of a size-3 vector
# axis, so every op runs over contiguous batch-length arrays. Each function
# mirrors its AoS twin op-for-op (same association order) so results match
# bit-for-bit.
# ---------------------------------------------------------------------------

def unstack3(v: jnp.ndarray):
    """[..., 3] -> (x, y, z) component arrays."""
    return v[..., 0], v[..., 1], v[..., 2]


def stack3(x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """(x, y, z) -> [..., 3]."""
    return jnp.stack([jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)],
                     axis=-1)


def dot_soa(a, b):
    """3-tuples of component arrays -> broadcasted dot product."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross_soa(a, b):
    """3-tuples of component arrays -> 3-tuple cross product."""
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def triangle_intersect_soa(o, d, v0, e1, e2):
    """Double-sided Möller-Trumbore on component tuples.

    `o`, `d`: ray origin/direction 3-tuples; `v0`: vertex-0 3-tuple;
    `e1`, `e2`: edge 3-tuples (v1-v0, v2-v0), all mutually broadcastable.
    Returns (t, u, v, orientation) shaped like the broadcast — the SoA twin
    of `triangle_intersect` (HalgoenCompute.compute:307-355).
    """
    pvec = cross_soa(d, e2)
    det = dot_soa(pvec, e1)
    parallel = jnp.abs(det) < DET_EPS
    inv_det = 1.0 / jnp.where(parallel, 1.0, det)
    tvec = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = dot_soa(tvec, pvec) * inv_det
    qvec = cross_soa(tvec, e1)
    v = dot_soa(d, qvec) * inv_det
    t = dot_soa(e2, qvec) * inv_det
    valid = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
    )
    t = jnp.where(valid, t, INF)
    return t, u, v, jnp.sign(det)


def ray_aabb_soa(lo, hi, o, inv_d):
    """Slab test on component tuples (SoA twin of `ray_aabb`,
    HalgoenCompute.compute:244-259). Returns tMin or +inf on miss."""
    t1x = (lo[0] - o[0]) * inv_d[0]
    t2x = (hi[0] - o[0]) * inv_d[0]
    t1y = (lo[1] - o[1]) * inv_d[1]
    t2y = (hi[1] - o[1]) * inv_d[1]
    t1z = (lo[2] - o[2]) * inv_d[2]
    t2z = (hi[2] - o[2]) * inv_d[2]
    tmin = jnp.maximum(
        jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
        jnp.minimum(t1z, t2z),
    )
    tmax = jnp.minimum(
        jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
        jnp.maximum(t1z, t2z),
    )
    return jnp.where(tmax > jnp.maximum(0.0, tmin), tmin, INF)


def sphere_intersect_soa(o, d, c, radius):
    """Quadratic sphere test on component tuples (SoA twin of
    `sphere_intersect`, HalgoenCompute.compute:266-303)."""
    oc = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
    b = 2.0 * dot_soa(oc, d)
    cq = dot_soa(oc, oc) - radius * radius
    disc = b * b - 4.0 * cq
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_near = (-b - sq) * 0.5
    t_far = (-b + sq) * 0.5
    inside = t_near < 0.0
    t = jnp.where(inside, t_far, t_near)
    orientation = jnp.where(inside, -1.0, 1.0)
    t = jnp.where(disc >= 0.0, t, INF)
    return t, orientation


# Tables of at most this many rows get the dense transpose in gather_rows.
ONEHOT_TRANSPOSE_MAX_ROWS = 128


@jax.custom_vjp
def gather_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """`table[idx]` for a [K, ...] table; a negative id gives a zero row
    (NOT python-style wrap-around), as does an id >= K.

    The forward is a plain gather. Its transpose (the gradient w.r.t. the
    table) is a scatter-add; the tables differentiated through here are
    material and emission tables of a few rows, each hit by millions of
    rays, and a scatter-add into so few rows serialises on atomic adds.
    For tables of at most ONEHOT_TRANSPOSE_MAX_ROWS rows the transpose is
    therefore a dense one-hot matmul, at HIGHEST precision so it stays
    float32. Measured on the H100 against a one-hot matmul forward and
    against plain autodiff of the gather (PERF.md, PR 1).
    """
    k = table.shape[0]
    return jnp.take(table, jnp.where(idx < 0, k, idx), axis=0,
                    mode="fill", fill_value=0)


def _gather_rows_fwd(table, idx):
    return gather_rows(table, idx), (table, idx)


def _gather_rows_bwd(res, ct):
    table, idx = res
    k = table.shape[0]
    d_idx = np.zeros(idx.shape, jax.dtypes.float0)
    if not jnp.issubdtype(table.dtype, jnp.inexact):
        return np.zeros(table.shape, jax.dtypes.float0), d_idx
    if k <= ONEHOT_TRANSPOSE_MAX_ROWS:
        onehot = (idx[..., None] == jnp.arange(k, dtype=idx.dtype)).astype(
            ct.dtype)
        axes = list(range(idx.ndim))
        d_table = jnp.tensordot(onehot, ct, axes=(axes, axes),
                                precision=jax.lax.Precision.HIGHEST)
    else:
        d_table = jnp.zeros(table.shape, ct.dtype).at[
            jnp.where(idx < 0, k, idx)].add(ct, mode="drop")
    return d_table.astype(table.dtype), d_idx


gather_rows.defvjp(_gather_rows_fwd, _gather_rows_bwd)


def reflect(incident: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection (HalgoenCompute.compute:506-509)."""
    return incident - 2.0 * dot(incident, normal)[..., None] * normal


def refract(incident: jnp.ndarray, normal: jnp.ndarray, n1, n2):
    """Snell refraction with total-internal-reflection handling
    (HalgoenCompute.compute:557-572).

    Returns (direction, tir_mask). On TIR the direction is the mirror
    reflection, as in the reference.
    """
    cos_theta = jnp.minimum(dot(-incident, normal), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    eta = n1 / n2
    tir = eta * sin_theta > 1.0
    r_perp = eta[..., None] * (incident + cos_theta[..., None] * normal)
    # |r_perp|^2, clamped like the reference's abs()
    perp_len2 = jnp.sum(r_perp * r_perp, axis=-1)
    r_par = -jnp.sqrt(jnp.abs(1.0 - perp_len2))[..., None] * normal
    refracted = r_perp + r_par
    reflected = reflect(incident, normal)
    return jnp.where(tir[..., None], reflected, refracted), tir


def schlick_adjusted_specular(
    n1, n2, normal: jnp.ndarray, incident: jnp.ndarray, min_spec, max_spec
):
    """Fresnel-adjusted specular probability (HalgoenCompute.compute:519-540):
    Schlick with entering/exiting handling, lerped into [min_spec, max_spec].
    """
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_x = -dot(normal, incident)
    n = n1 / n2
    sin_t2 = n * n * (1.0 - cos_x * cos_x)
    exiting = n1 > n2
    tir = exiting & (sin_t2 > 1.0)
    cos_x = jnp.where(
        exiting, jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t2)), cos_x
    )
    x = 1.0 - cos_x
    ret = r0 + (1.0 - r0) * x * x * x * x * x
    out = min_spec + (max_spec - min_spec) * ret
    return jnp.where(tir, max_spec, out)


def procedural_glossy_pdf(
    omega: jnp.ndarray,
    mirror: jnp.ndarray,
    alpha: jnp.ndarray,
    normal: jnp.ndarray,
) -> jnp.ndarray:
    """Exact solid-angle pdf of the reference's procedural glossy lobe.

    The reference samples glossy directions as
    `normalize(lerp(reflect(d,n), dd, roughness^2))` with dd cosine-
    distributed about n (`HalgoenCompute.compute:691-704` via
    lambertian_scatter, compute:491-501). Writing a = roughness^2, the
    pre-normalization point v = (1-a)*mirror + a*dd lies on a sphere of
    radius a centered at c = (1-a)*mirror; normalization projects it to
    the unit direction omega. The density therefore transforms with the
    sphere-to-solid-angle Jacobian

        pdf(omega) = sum_roots  cos(dd_i . n)/pi * t_i^2 / (a^2 |omega . dd_i|)

    where t_i are the positive roots of |omega t - c| = a, i.e.
    t^2 - 2 (1-a)(omega.mirror) t + ((1-a)^2 - a^2) = 0, and
    dd_i = (omega t_i - c)/a are the cosine-lobe preimages. Two roots
    contribute when the origin lies outside the offset sphere (a < 1/2).
    At a = 1 this reduces to the plain cosine pdf; at a = 0 the lobe is
    a delta (this function returns 0 — deltas get MIS weight 1 and no
    NEE coverage). This closed form is what makes MIS with the
    reference's exact glossy sampling possible (its own MIS TODO,
    HalgoenCompute.compute:19).
    """
    a1 = jnp.asarray(alpha)
    b = (1.0 - a1) * dot(omega, mirror)
    c = (1.0 - a1) ** 2 - a1 ** 2
    disc = b * b - c
    eps = np.float32(1e-6)
    exists = (a1 > eps) & (disc >= 0.0)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    a_safe = jnp.maximum(a1, eps)
    total = jnp.zeros_like(b)
    for t in (b - sq, b + sq):
        valid = exists & (t > eps)
        t_safe = jnp.where(valid, t, 1.0)
        dd = (omega * t_safe[..., None]
              - (1.0 - a_safe)[..., None] * mirror) / a_safe[..., None]
        cos_dd = jnp.maximum(dot(dd, normal), 0.0)
        dens = (cos_dd * np.float32(1.0 / np.pi)
                * t_safe * t_safe
                / (a_safe * a_safe
                   * jnp.maximum(jnp.abs(dot(omega, dd)), eps)))
        total = total + jnp.where(valid, dens, 0.0)
    return total


def lambertian_scatter(normal: jnp.ndarray, random_unit: jnp.ndarray) -> jnp.ndarray:
    """Cosine-ish scatter: normalize(normal + uniform unit vector), guarding
    the degenerate opposite-vector case (HalgoenCompute.compute:491-501)."""
    s = normal + random_unit
    tiny = jnp.sum(s * s, axis=-1, keepdims=True) < np.float32(1e-16)
    s = jnp.where(tiny, normal, s)
    return normalize(s)


def lerp(a, b, t):
    return a + (b - a) * t
