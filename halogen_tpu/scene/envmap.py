"""Environment map: equirectangular radiance map with a mip pyramid.

A redesign of the reference's environment cubemap + trilinear mip sampling
(`HalgoenCompute.compute:196-204`, imported 2048px cubemap per
`resting_place_4k.exr.meta`): a single equirectangular [H, W, 3] texture
avoids cubemap face-selection branching and keeps lookups as one gather.
Mip levels are 2x box-downsampled; `sample_env` does trilinear filtering
(bilinear with azimuth wrap + inter-mip blend) at a float mip level, like
the reference's hardware `SampleLevel` with `DefaultHDRIMipLevel` plus the
accumulated-roughness bias (`HalgoenCompute.compute:940-945`). NEE uses
`sample_env_mip_nearest` so radiance stays texel-consistent with the
luminance-CDF pdf tables.

Also provides luminance CDF tables for envmap importance sampling — a
capability the reference lists as TODO (`HalgoenCompute.compute:19` "Multiple
Importance Sampling") and ladder config 3 (BASELINE.md) uses.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import jax.numpy as jnp

from halogen_tpu.core.math import normalize


@dataclasses.dataclass
class Envmap:
    """Host-side envmap: list of [H, W, 3] float32 mips, finest first."""

    mips: List[np.ndarray]

    @staticmethod
    def from_equirect(image: np.ndarray, num_mips: int = 6) -> "Envmap":
        img = np.asarray(image, np.float32)
        assert img.ndim == 3 and img.shape[2] == 3
        mips = [img]
        for _ in range(num_mips - 1):
            cur = mips[-1]
            h, w = cur.shape[:2]
            if h < 2 or w < 2:
                break
            h2, w2 = h // 2 * 2, w // 2 * 2
            cur = cur[:h2, :w2]
            mips.append(
                0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                        + cur[0::2, 1::2] + cur[1::2, 1::2])
            )
        return Envmap(mips)

    @staticmethod
    def constant(color, size: int = 8) -> "Envmap":
        img = np.broadcast_to(
            np.asarray(color, np.float32), (size, 2 * size, 3)
        ).copy()
        return Envmap.from_equirect(img, num_mips=2)

    @staticmethod
    def gradient_sky(
        horizon=(0.1, 0.1, 0.1), zenith=(0.5, 0.7, 1.0), scale=0.7,
        height: int = 64,
    ) -> "Envmap":
        """The commented-out procedural sky in the reference
        (HalgoenCompute.compute:198-199): lerp(horizon, zenith, 0.5*(y+1)) * scale."""
        h, w = height, height * 2
        theta = (np.arange(h) + 0.5) / h * np.pi  # [0, pi] from +y pole
        y = np.cos(theta)
        v = 0.5 * (y + 1.0)
        row = (np.outer(1 - v, np.asarray(horizon))
               + np.outer(v, np.asarray(zenith))) * scale
        img = np.repeat(row[:, None, :], w, axis=1).astype(np.float32)
        return Envmap.from_equirect(img)


def dir_to_equirect_uv(d: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Direction [..., 3] (y-up) -> equirect (u, v) in [0,1).

    u wraps azimuth (atan2(x, -z)), v runs 0 at +y (zenith) to 1 at -y.
    """
    d = normalize(d)
    u = (jnp.arctan2(d[..., 0], -d[..., 2]) / (2.0 * np.pi)) + 0.5
    v = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) / np.pi
    return u, v


def sample_env_mip_nearest(
    mip: jnp.ndarray, direction: jnp.ndarray
) -> jnp.ndarray:
    """Nearest-texel lookup of one [H, W, 3] mip for [..., 3] directions.

    Used by envmap NEE, where radiance must stay texel-consistent with the
    luminance-CDF pdf tables (a filtered lookup would spread bright texels
    onto neighbors whose pdf is tiny -> unbounded-weight fireflies)."""
    h, w = mip.shape[0], mip.shape[1]
    u, v = dir_to_equirect_uv(direction)
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    flat = mip.reshape(-1, 3)
    return flat[y * w + x]


def sample_env_mip(mip: jnp.ndarray, direction: jnp.ndarray) -> jnp.ndarray:
    """Bilinear lookup of one [H, W, 3] mip for [..., 3] directions.

    Texel centers sit at (i + 0.5)/size; the azimuth (x) axis wraps — the
    equirect seam is continuous — and the polar (y) axis clamps at the
    poles. Matches the reference's hardware bilinear tap
    (HalgoenCompute.compute:196-204 SampleLevel on the cubemap sampler).
    """
    h, w = mip.shape[0], mip.shape[1]
    u, v = dir_to_equirect_uv(direction)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    wx = fx - x0
    wy = fy - y0
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    # Clamp the two row indices INDEPENDENTLY from the unclamped y0:
    # above the top texel center y0 = -1 must give (0, 0), not (0, 1) —
    # clamping y0 first would reintroduce a discontinuity at the pole
    # rows that a 1-ulp change in v (eager vs jit acos) can cross.
    y0u = y0.astype(jnp.int32)
    y0i = jnp.clip(y0u, 0, h - 1)
    y1i = jnp.clip(y0u + 1, 0, h - 1)
    flat = mip.reshape(-1, 3)
    c00 = flat[y0i * w + x0i]
    c01 = flat[y0i * w + x1i]
    c10 = flat[y1i * w + x0i]
    c11 = flat[y1i * w + x1i]
    wxe = wx[..., None]
    top = c00 + (c01 - c00) * wxe
    bot = c10 + (c11 - c10) * wxe
    return top + (bot - top) * wy[..., None]


def sample_env(
    env_mips: Tuple[jnp.ndarray, ...],
    direction: jnp.ndarray,
    level: jnp.ndarray,
) -> jnp.ndarray:
    """Trilinear sample of the pyramid at per-ray float mip `level`.

    Bilinear within each mip plus a linear blend between the two mips
    bracketing `level` — the equivalent of the reference's hardware
    trilinear `SampleLevel` on the environment cubemap
    (HalgoenCompute.compute:196-204). Integer `level` inputs reduce to
    pure bilinear at that mip.

    Implementation: all mips concatenate into one flat texel atlas and
    the per-ray tap indices address it directly, so each ray costs 8
    gathers (4 bilinear taps x 2 bracketing mips) regardless of pyramid
    depth — computing every mip's bilinear and masking (the obvious
    branch-free form) is 3x the gather traffic.
    """
    if not env_mips:
        return jnp.zeros(direction.shape[:-1] + (3,), jnp.float32)
    n_mips = len(env_mips)
    level = jnp.clip(level.astype(jnp.float32), 0.0, float(n_mips - 1))
    if n_mips == 1:
        return sample_env_mip(env_mips[0], direction)

    # static atlas layout
    sizes = [(int(m.shape[0]), int(m.shape[1])) for m in env_mips]
    offs = [0]
    for h, w in sizes:
        offs.append(offs[-1] + h * w)
    atlas = jnp.concatenate([m.reshape(-1, 3) for m in env_mips], axis=0)
    hs = jnp.asarray([h for h, _ in sizes], jnp.float32)
    ws = jnp.asarray([w for _, w in sizes], jnp.float32)
    off_arr = jnp.asarray(offs[:-1], jnp.int32)

    l0 = jnp.floor(level).astype(jnp.int32)
    l0 = jnp.clip(l0, 0, n_mips - 2)
    frac = (level - l0.astype(jnp.float32))[..., None]
    u, v = dir_to_equirect_uv(direction)

    def bilin(li):
        h = jnp.take(hs, li)
        w = jnp.take(ws, li)
        off = jnp.take(off_arr, li)
        wi = w.astype(jnp.int32)
        hi = h.astype(jnp.int32)
        fx = u * w - 0.5
        fy = v * h - 0.5
        x0 = jnp.floor(fx)
        y0 = jnp.floor(fy)
        wx = (fx - x0)[..., None]
        wy = (fy - y0)[..., None]
        x0i = jnp.mod(x0.astype(jnp.int32), wi)
        x1i = jnp.mod(x0i + 1, wi)
        y0u = y0.astype(jnp.int32)
        y0i = jnp.clip(y0u, 0, hi - 1)
        y1i = jnp.clip(y0u + 1, 0, hi - 1)
        c00 = atlas[off + y0i * wi + x0i]
        c01 = atlas[off + y0i * wi + x1i]
        c10 = atlas[off + y1i * wi + x0i]
        c11 = atlas[off + y1i * wi + x1i]
        top = c00 + (c01 - c00) * wx
        bot = c10 + (c11 - c10) * wx
        return top + (bot - top) * wy

    a = bilin(l0)
    b = bilin(jnp.minimum(l0 + 1, n_mips - 1))
    return a + (b - a) * frac


# ---------------------------------------------------------------------------
# Importance sampling tables (capability beyond the reference — its
# "importance sampling" is the mip-bias hack; MIS is its TODO,
# HalgoenCompute.compute:19).
# ---------------------------------------------------------------------------

class EnvCDF(NamedTuple):
    """Luminance-distribution tables for envmap next-event estimation.

    Sampling uses Walker/Vose alias tables instead of inverse-CDF
    search: a draw is texel-index arithmetic plus two one-element table
    reads, where the CDF inversion needed a [W]-wide compare-and-sum
    per draw. The sampled distribution is exactly the same
    solid-angle-weighted luminance measure.

    `draw_static` fuses the per-draw table rows, so the draw's four
    lookups (alias_p, alias_j, stay-pdf, alias-pdf) ride ONE row gather
    of contiguous memory instead of four scattered ones; the
    radiance of both branches is appended inside the traced function
    (sample_env_draw) so envmap gradients still flow.
    """

    alias_p: jnp.ndarray  # [H*W] stay-probability (Vose)
    alias_j: jnp.ndarray  # [H*W] int32 alias texel
    pdf: jnp.ndarray  # [H, W] solid-angle pdf
    # [H*W, 4]: alias_p | alias_j (as f32) | pdf[texel] | pdf[alias_j]
    draw_static: jnp.ndarray | None = None


def build_env_cdf(env: np.ndarray) -> EnvCDF:
    """Alias tables + pdf over solid-angle-weighted luminance of an
    equirect map [H, W, 3]; pdf is w.r.t. solid angle."""
    h, w = env.shape[:2]
    lum = np.asarray(env, np.float32) @ np.asarray(
        [0.2126, 0.7152, 0.0722], np.float32)
    sin_theta = np.sin((np.arange(h) + 0.5) / h * np.pi).astype(np.float32)
    weight = lum * sin_theta[:, None] + 1e-12
    # pdf(direction) = weight / (total * texel_solid_angle)
    texel_sa = (2 * np.pi / w) * (np.pi / h) * sin_theta[:, None]
    pdf = weight / (weight.sum() * texel_sa)

    # Vose alias construction (float64 for a clean partition)
    p = (weight / weight.sum()).reshape(-1).astype(np.float64)
    n = p.size
    scaled = p * n
    alias_p = np.ones(n, np.float64)
    alias_j = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        alias_p[s] = scaled[s]
        alias_j[s] = g
        scaled[g] = scaled[g] - (1.0 - scaled[s])
        (small if scaled[g] < 1.0 else large).append(g)
    for i in small + large:
        alias_p[i] = 1.0
    pdf_flat = pdf.reshape(-1)
    draw_static = np.stack(
        [alias_p.astype(np.float32), alias_j.astype(np.float32),
         pdf_flat.astype(np.float32),
         pdf_flat[alias_j].astype(np.float32)], axis=1)
    return EnvCDF(
        jnp.asarray(alias_p.astype(np.float32)),
        jnp.asarray(alias_j.astype(np.int32)),
        jnp.asarray(pdf.astype(np.float32)),
        jnp.asarray(draw_static),
    )


def sample_env_direction(cdf: EnvCDF, u1, u2):
    """Alias-method sample of a direction from the luminance
    distribution. Returns ([..., 3] directions, pdf [...] w.r.t. solid
    angle). `u1` picks the column, `u2` is the stay/alias threshold —
    the single-uniform trick (threshold from the fractional bits of
    u1*n) loses all threshold resolution once n approaches 2^24 in
    float32 (at 2048x1024 the branch probability is already off by
    ~5pp; at >=4k maps the alias branch would never be taken), so the
    two-uniform form is required for real HDRI sizes."""
    h, w = cdf.pdf.shape
    n = h * w
    r = jnp.clip(u1, 0.0, np.float32(1.0 - 1e-7)) * n
    idx = jnp.clip(r.astype(jnp.int32), 0, n - 1)
    texel = jnp.where(u2 < cdf.alias_p[idx], idx, cdf.alias_j[idx])
    row = texel // w
    col = texel - row * w
    theta = (row.astype(jnp.float32) + 0.5) / h * np.pi
    phi = ((col.astype(jnp.float32) + 0.5) / w - 0.5) * 2.0 * np.pi
    sin_t = jnp.sin(theta)
    d = jnp.stack(
        [sin_t * jnp.sin(phi), jnp.cos(theta), -sin_t * jnp.cos(phi)], axis=-1
    )
    return d, cdf.pdf.reshape(-1)[texel]


def sample_env_draw(cdf: EnvCDF, env0: jnp.ndarray, u1, u2):
    """One-row-gather NEE draw: ([..., 3] direction, pdf [...],
    radiance [..., 3]) from the luminance distribution.

    Fuses what took four separate gathers per (ray, bounce) —
    alias_p[idx], alias_j[idx], pdf[texel], env0[texel] — into ONE
    [T, 10] row gather of contiguous memory. The radiance
    columns come from `env0` (the finest mip) inside the traced
    function, so d(radiance)/d(env_mips) still flows; radiance is the
    exact texel value (the former `sample_env_mip_nearest(env0, dir)`
    round-tripped dir -> uv -> the same texel)."""
    h, w = cdf.pdf.shape
    n = h * w
    flat = env0.reshape(-1, 3)
    tab = jnp.concatenate(
        [cdf.draw_static, flat, flat[cdf.alias_j]], axis=1)  # [T, 10]
    r = jnp.clip(u1, 0.0, np.float32(1.0 - 1e-7)) * n
    idx = jnp.clip(r.astype(jnp.int32), 0, n - 1)
    row = tab[idx]  # [..., 10]
    stay = u2 < row[..., 0]
    texel = jnp.where(stay, idx, row[..., 1].astype(jnp.int32))
    pdf = jnp.where(stay, row[..., 2], row[..., 3])
    rad = jnp.where(stay[..., None], row[..., 4:7], row[..., 7:10])
    rowi = texel // w
    col = texel - rowi * w
    theta = (rowi.astype(jnp.float32) + 0.5) / h * np.pi
    phi = ((col.astype(jnp.float32) + 0.5) / w - 0.5) * 2.0 * np.pi
    sin_t = jnp.sin(theta)
    d = jnp.stack(
        [sin_t * jnp.sin(phi), jnp.cos(theta), -sin_t * jnp.cos(phi)],
        axis=-1)
    return d, pdf, rad


def pack_footprint(mip: jnp.ndarray) -> jnp.ndarray:
    """[H, W, 3] mip -> [H*W, 12] bilinear-footprint rows: the 2x2 texel
    quad anchored at (y, x) with azimuth wrap on x and pole clamp on y
    baked in, so one row gather serves a whole bilinear tap (4 taps of
    3 gathered elements each -> 1 contiguous row). Pure jnp so envmap
    gradients flow through the packing."""
    xp = jnp.roll(mip, -1, axis=1)          # (x+1 mod W, y)
    yc = jnp.concatenate([mip[1:], mip[-1:]], axis=0)    # (x, min(y+1,H-1))
    xyc = jnp.concatenate([xp[1:], xp[-1:]], axis=0)
    return jnp.concatenate(
        [mip, xp, yc, xyc], axis=2).reshape(-1, 12)


def sample_env_packed(
    env_mips: Tuple[jnp.ndarray, ...],
    direction: jnp.ndarray,
    level: jnp.ndarray,
) -> jnp.ndarray:
    """`sample_env` with footprint-packed row gathers: identical taps
    and blend formulas (images match to float identity), but each
    bilinear costs ONE row gather instead of four (8 -> 2 gathers per
    trilinear sky fetch; the deferred sky fetch was measured at 376
    ms/frame on the 1024^2 ladder-3 config with the tap-wise form)."""
    if not env_mips:
        return jnp.zeros(direction.shape[:-1] + (3,), jnp.float32)
    n_mips = len(env_mips)
    level = jnp.clip(level.astype(jnp.float32), 0.0, float(n_mips - 1))

    sizes = [(int(m.shape[0]), int(m.shape[1])) for m in env_mips]
    offs = [0]
    for h, w in sizes:
        offs.append(offs[-1] + h * w)
    atlas = jnp.concatenate([pack_footprint(m) for m in env_mips], axis=0)
    hs = jnp.asarray([h for h, _ in sizes], jnp.float32)
    ws = jnp.asarray([w for _, w in sizes], jnp.float32)
    off_arr = jnp.asarray(offs[:-1], jnp.int32)

    if n_mips == 1:
        l0 = jnp.zeros(direction.shape[:-1], jnp.int32)
    else:
        l0 = jnp.clip(jnp.floor(level).astype(jnp.int32), 0, n_mips - 2)
    frac = (level - l0.astype(jnp.float32))[..., None]
    u, v = dir_to_equirect_uv(direction)

    def bilin(li):
        h = jnp.take(hs, li)
        w = jnp.take(ws, li)
        off = jnp.take(off_arr, li)
        wi = w.astype(jnp.int32)
        hi = h.astype(jnp.int32)
        fx = u * w - 0.5
        fy = v * h - 0.5
        x0 = jnp.floor(fx)
        y0 = jnp.floor(fy)
        wx = (fx - x0)[..., None]
        wy = (fy - y0)[..., None]
        x0i = jnp.mod(x0.astype(jnp.int32), wi)
        y0u = y0.astype(jnp.int32)
        y0i = jnp.clip(y0u, 0, hi - 1)
        # the footprint row bakes y1 = min(y0+1, H-1); above the top
        # texel center (y0u = -1) both taps must be row 0, which the
        # stored (row0, row1) pair reproduces with wy forced to 0
        wy = jnp.where((y0u < 0)[..., None], 0.0, wy)
        row = atlas[off + y0i * wi + x0i]  # [..., 12]
        c00, c01 = row[..., 0:3], row[..., 3:6]
        c10, c11 = row[..., 6:9], row[..., 9:12]
        top = c00 + (c01 - c00) * wx
        bot = c10 + (c11 - c10) * wx
        return top + (bot - top) * wy

    a = bilin(l0)
    if n_mips == 1:
        return a
    b = bilin(jnp.minimum(l0 + 1, n_mips - 1))
    return a + (b - a) * frac


def env_pdf(cdf: EnvCDF, direction: jnp.ndarray) -> jnp.ndarray:
    """Solid-angle pdf of the luminance distribution for [..., 3] dirs
    (the MIS weight for BRDF samples that reach the sky)."""
    h, w = cdf.pdf.shape
    u, v = dir_to_equirect_uv(direction)
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return cdf.pdf[y, x]
