"""Geometry math unit tests: hand-computed cases for intersection,
refraction, Schlick, and the slab test (SURVEY.md §4a)."""

import pytest
import numpy as np
import jax.numpy as jnp

from halogen_tpu.core import math as gm


def _v(*xs):
    return jnp.asarray([xs], dtype=jnp.float32)


def test_ray_aabb_hit_miss():
    lo = _v(-1.0, -1.0, -1.0)
    hi = _v(1.0, 1.0, 1.0)
    o = _v(0.0, 0.0, -5.0)
    d = _v(0.0, 0.0, 1.0)
    t = gm.ray_aabb(lo, hi, o, 1.0 / d)
    np.testing.assert_allclose(np.asarray(t), [4.0], rtol=1e-6)
    # miss
    o2 = _v(5.0, 0.0, -5.0)
    t2 = gm.ray_aabb(lo, hi, o2, 1.0 / d)
    assert np.isinf(np.asarray(t2)[0])


def test_ray_aabb_inside_returns_negative_entry():
    lo, hi = _v(-1, -1, -1), _v(1, 1, 1)
    o, d = _v(0, 0, 0), _v(0, 0, 1.0)
    t = np.asarray(gm.ray_aabb(lo, hi, o, 1.0 / d))[0]
    assert t < 0  # reference semantics: entry distance, may be negative


def test_sphere_intersect_outside_and_inside():
    c = _v(0.0, 0.0, 0.0)
    r = jnp.asarray([1.0], jnp.float32)
    o = _v(0.0, 0.0, -3.0)
    d = _v(0.0, 0.0, 1.0)
    t, orient = gm.sphere_intersect(o, d, c, r)
    np.testing.assert_allclose(np.asarray(t), [2.0], rtol=1e-6)
    assert np.asarray(orient)[0] == 1.0
    # from inside: far root, orientation -1
    o2 = _v(0.0, 0.0, 0.0)
    t2, orient2 = gm.sphere_intersect(o2, d, c, r)
    np.testing.assert_allclose(np.asarray(t2), [1.0], rtol=1e-6)
    assert np.asarray(orient2)[0] == -1.0


def test_sphere_miss():
    c, r = _v(0, 0, 0), jnp.asarray([1.0], jnp.float32)
    o, d = _v(0, 5, -3), _v(0, 0, 1.0)
    t, _ = gm.sphere_intersect(o, d, c, r)
    assert np.isinf(np.asarray(t)[0])


def test_triangle_intersect_center_hit():
    v0 = _v(-1.0, -1.0, 0.0)
    v1 = _v(1.0, -1.0, 0.0)
    v2 = _v(0.0, 1.0, 0.0)
    o = _v(0.0, -0.2, -2.0)
    d = _v(0.0, 0.0, 1.0)
    t, u, v, s = gm.triangle_intersect(o, d, v0, v1, v2)
    np.testing.assert_allclose(np.asarray(t), [2.0], rtol=1e-6)
    # barycentric identity: hit point = v0 + e1*u + e2*v
    hp = np.asarray(v0 + (v1 - v0) * u + (v2 - v0) * v)[0]
    np.testing.assert_allclose(hp, [0.0, -0.2, 0.0], atol=1e-6)
    assert abs(np.asarray(s)[0]) == 1.0


def test_triangle_double_sided():
    v0, v1, v2 = _v(-1, -1, 0), _v(1, -1, 0), _v(0, 1, 0)
    o, d = _v(0, -0.2, 2.0), _v(0, 0, -1.0)
    t, u, v, s_back = gm.triangle_intersect(o, d, v0, v1, v2)
    assert np.isfinite(np.asarray(t)[0])
    o2, d2 = _v(0, -0.2, -2.0), _v(0, 0, 1.0)
    _, _, _, s_front = gm.triangle_intersect(o2, d2, v0, v1, v2)
    # opposite orientations from the two sides
    assert np.asarray(s_back)[0] == -np.asarray(s_front)[0]


def test_triangle_miss_outside():
    v0, v1, v2 = _v(-1, -1, 0), _v(1, -1, 0), _v(0, 1, 0)
    o, d = _v(2.0, 2.0, -2.0), _v(0, 0, 1.0)
    t, *_ = gm.triangle_intersect(o, d, v0, v1, v2)
    assert np.isinf(np.asarray(t)[0])


def test_reflect():
    i = _v(1.0, -1.0, 0.0) / np.sqrt(2)
    n = _v(0.0, 1.0, 0.0)
    r = np.asarray(gm.reflect(i, n))[0]
    np.testing.assert_allclose(r, np.asarray(_v(1.0, 1.0, 0.0) / np.sqrt(2))[0],
                               atol=1e-6)


def test_refract_snell():
    # 45 degrees into glass n=1.5: sin(t) = sin(45)/1.5
    i = _v(np.sin(np.pi / 4), -np.cos(np.pi / 4), 0.0)
    n = _v(0.0, 1.0, 0.0)
    d, tir = gm.refract(i, n, jnp.asarray([1.0]), jnp.asarray([1.5]))
    d = np.asarray(d)[0]
    assert not np.asarray(tir)[0]
    sin_t = abs(d[0]) / np.linalg.norm(d)
    np.testing.assert_allclose(sin_t, np.sin(np.pi / 4) / 1.5, rtol=1e-5)
    assert d[1] < 0  # continues downward


def test_refract_tir():
    # From glass to air beyond the critical angle ~41.8deg
    ang = np.deg2rad(60.0)
    i = _v(np.sin(ang), -np.cos(ang), 0.0)
    n = _v(0.0, 1.0, 0.0)
    d, tir = gm.refract(i, n, jnp.asarray([1.5]), jnp.asarray([1.0]))
    assert np.asarray(tir)[0]
    # TIR falls back to mirror reflection
    np.testing.assert_allclose(
        np.asarray(d)[0], np.asarray(gm.reflect(i, n))[0], atol=1e-6
    )


def test_schlick_normal_incidence():
    # n1=1, n2=1.5 head-on: r0 = ((1-1.5)/(2.5))^2 = 0.04
    n = _v(0.0, 1.0, 0.0)
    i = _v(0.0, -1.0, 0.0)
    got = np.asarray(
        gm.schlick_adjusted_specular(
            jnp.asarray([1.0]), jnp.asarray([1.5]), n, i,
            jnp.asarray([0.0]), jnp.asarray([1.0]),
        )
    )[0]
    np.testing.assert_allclose(got, 0.04, rtol=1e-5)


def test_schlick_grazing_is_one():
    n = _v(0.0, 1.0, 0.0)
    i = _v(1.0, -1e-4, 0.0)
    got = np.asarray(
        gm.schlick_adjusted_specular(
            jnp.asarray([1.0]), jnp.asarray([1.5]), n, i,
            jnp.asarray([0.0]), jnp.asarray([1.0]),
        )
    )[0]
    assert got > 0.98


def test_schlick_tir_returns_max():
    ang = np.deg2rad(60.0)
    n = _v(0.0, 1.0, 0.0)
    i = _v(np.sin(ang), -np.cos(ang), 0.0)
    got = np.asarray(
        gm.schlick_adjusted_specular(
            jnp.asarray([1.5]), jnp.asarray([1.0]), n, i,
            jnp.asarray([0.3]), jnp.asarray([0.9]),
        )
    )[0]
    np.testing.assert_allclose(got, 0.9, rtol=1e-6)


def test_lambertian_scatter_degenerate():
    n = _v(0.0, 1.0, 0.0)
    opposite = _v(0.0, -1.0, 0.0)
    s = np.asarray(gm.lambertian_scatter(n, opposite))[0]
    np.testing.assert_allclose(s, [0, 1, 0], atol=1e-6)


def test_transform_normal_nonuniform_scale():
    # Scaling z by 2: a plane normal (0,0,1) must stay (0,0,1) after
    # inverse-transpose transform + normalize, not (0,0,2)-ish skew.
    l2w = np.diag([1.0, 1.0, 2.0, 1.0]).astype(np.float32)
    w2l = np.linalg.inv(l2w)
    n = gm.transform_normal(jnp.asarray(w2l)[None], _v(0.0, 0.0, 1.0))
    n = np.asarray(gm.normalize(n))[0]
    np.testing.assert_allclose(n, [0, 0, 1], atol=1e-6)
    # skewed case: normal of a 45deg plane under z-scale
    n2 = gm.transform_normal(jnp.asarray(w2l)[None],
                             _v(0.0, 1.0, 1.0) / np.sqrt(2))
    n2 = np.asarray(gm.normalize(n2))[0]
    # z-component must shrink relative to y (plane flattens)
    assert n2[1] > n2[2] > 0


@pytest.mark.slow
def test_procedural_glossy_pdf_is_a_density():
    """MC validation of core.math.procedural_glossy_pdf: it must (a)
    integrate to ~1 over the sphere and (b) match the empirical density
    of the reference's actual sampling procedure (normalize(lerp(mirror,
    cosine_dir, a))) in cones around the lobe."""
    import numpy as np
    import jax.numpy as jnp
    from halogen_tpu.core.math import (
        lambertian_scatter,
        lerp,
        normalize,
        procedural_glossy_pdf,
        reflect,
    )

    rng = np.random.default_rng(3)
    n = jnp.asarray([0.0, 0.0, 1.0])
    d = normalize(jnp.asarray([0.5, 0.2, -0.8]))
    r = reflect(d, n)

    for a in (0.2, 0.6, 1.0):
        # (a) integral over the sphere by uniform MC
        us = normalize(jnp.asarray(
            rng.normal(size=(120000, 3)).astype(np.float32)))
        pv = np.asarray(procedural_glossy_pdf(
            us, jnp.broadcast_to(r, us.shape),
            jnp.full((len(us),), a, jnp.float32),
            jnp.broadcast_to(n, us.shape)))
        integral = pv.mean() * 4 * np.pi
        assert abs(integral - 1.0) < 0.08, (a, integral)

        # (b) empirical cone densities from the actual procedure
        N = 200000
        u = rng.random((N, 2)).astype(np.float32)
        theta = u[:, 0] * 2 * np.pi
        cph = 2 * u[:, 1] - 1
        sph = np.sqrt(np.maximum(0, 1 - cph * cph))
        rv = jnp.asarray(
            np.stack([sph * np.cos(theta), sph * np.sin(theta), cph], -1))
        dd = lambertian_scatter(jnp.broadcast_to(n, (N, 3)), rv)
        w = np.asarray(normalize(
            lerp(jnp.broadcast_to(r, (N, 3)), dd, jnp.float32(a))))
        offs = rng.normal(size=(8, 3)).astype(np.float32) * a * 0.8
        probes = normalize(jnp.asarray(np.asarray(r)[None, :] + offs))
        pp = np.asarray(procedural_glossy_pdf(
            probes, jnp.broadcast_to(r, (8, 3)),
            jnp.full((8,), a, jnp.float32), jnp.broadcast_to(n, (8, 3))))
        cos_eps = 1 - (0.15 * a) ** 2 / 2
        sa = 2 * np.pi * (1 - cos_eps)
        emp = ((w @ np.asarray(probes).T) > cos_eps).mean(axis=0) / sa
        m = pp > pp.max() * 0.05
        ratio = emp[m] / pp[m]
        assert (np.abs(ratio - 1.0) < 0.25).all(), (a, ratio)


@pytest.mark.parametrize("k", [5, 300])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_rows_matches_take_with_zero_rows(k, dtype):
    """gather_rows == np.take for valid ids; a negative id or one past the
    table gives an all-zero row (no wrap-around)."""
    rng = np.random.default_rng(k)
    table = (rng.normal(size=(k, 3, 2)) * 100).astype(dtype)
    idx = np.concatenate([rng.integers(0, k, size=64), [-1, -k, k, k + 7]])
    got = np.asarray(gm.gather_rows(jnp.asarray(table),
                                    jnp.asarray(idx, jnp.int32)))
    assert got.dtype == table.dtype
    np.testing.assert_array_equal(got[:64], np.take(table, idx[:64], axis=0))
    np.testing.assert_array_equal(got[64:], 0)


@pytest.mark.parametrize("k", [5, 300])
def test_gather_rows_gradient_is_segment_sum(k):
    """The gradient w.r.t. the table adds each row's cotangents (dense
    one-hot transpose for small tables, scatter-add for big ones); ids
    outside the table contribute nothing."""
    import jax

    rng = np.random.default_rng(1)
    table = jnp.asarray(rng.normal(size=(k, 4)), jnp.float32)
    idx = np.concatenate([rng.integers(0, k, size=200), [-1, k]])
    w = rng.normal(size=(idx.size, 4)).astype(np.float32)
    g = jax.grad(lambda t: jnp.sum(
        gm.gather_rows(t, jnp.asarray(idx, jnp.int32)) * w))(table)
    want = np.zeros((k, 4), np.float64)
    np.add.at(want, idx[:200], w[:200])
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5, atol=1e-5)
