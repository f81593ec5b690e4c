"""Owen-scrambled Sobol low-discrepancy sampler on uint32.

Re-implements the sampler contract of the reference's
`Halogen Shaders/HalogenRandom.hlsl` with exact uint32 bit semantics so that
CPU, GPU, and gradient-replay traces agree:

- 4-dimensional Sobol direction table (`HalogenRandom.hlsl:10-46`, standard
  Joe-Kuo direction numbers) with higher dimensions padded by hashing.
- Burley hash-based Owen scramble / shuffle (`HalogenRandom.hlsl:140-161`),
  the improved Laine-Karras hash from psychopath.io / PBRT.
- PCG hash (`HalogenRandom.hlsl:110-115`) for seeds and the PRNG ablation.
- `hash_combine` (`HalogenRandom.hlsl:131-133`).
- Per-event dimension IDs with a stride of 5 per bounce
  (`HalogenRandom.hlsl:61-74`).

Deliberate redesign (SURVEY.md §3.4): the reference never resets its
per-thread `SobolDimensionOffset` between samples-per-pixel iterations, so
in-frame spp decorrelation comes only from dimension hashing and the sample
*index* is pinned to the frame counter. Here the sample index is
`frame * spp + spp_idx` and the dimension counter restarts per sample — the
standard low-discrepancy construction, and a requirement for sharding the
spp axis across devices.

All functions are stateless and vectorized: inputs are uint32 arrays of any
(broadcastable) shape; everything lowers to elementwise bitwise ops under
jit.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Dimension IDs for the random events of a path (HalogenRandom.hlsl:61-74).
# Camera events use the base IDs; bounce k uses ID + 5*k.
# ---------------------------------------------------------------------------
DIM_FOCAL_DISC = 0
DIM_RAY_JITTER = 1
DIM_ROUGH_REFLECTION = 2
DIM_MATERIAL_BRDF = 3
DIM_RUSSIAN_ROULETTE = 4
BOUNCE_DIM_STRIDE = 5
# Next-event estimation lives in disjoint dimension bands so the
# reference's 5-events-per-bounce stream (above) is untouched whether or not
# NEE is enabled. Dimensions are hash-padded, so any distinct ids work.
DIM_ENV_NEE_BASE = 1 << 16
DIM_LIGHT_NEE_SEL = 1 << 17  # emissive-tri selection (1D)
DIM_LIGHT_NEE_POINT = (1 << 17) + 1  # barycentric point (2D)

_U32 = jnp.uint32

# 4 x 32 Sobol direction numbers (HalogenRandom.hlsl:10-46; these are the
# standard first-four-dimension Joe-Kuo direction numbers).
_SOBOL_DIRECTIONS = np.array(
    [
        [1 << (31 - b) for b in range(32)],
        [0x80000000, 0xC0000000, 0xA0000000, 0xF0000000,
         0x88000000, 0xCC000000, 0xAA000000, 0xFF000000,
         0x80800000, 0xC0C00000, 0xA0A00000, 0xF0F00000,
         0x88880000, 0xCCCC0000, 0xAAAA0000, 0xFFFF0000,
         0x80008000, 0xC000C000, 0xA000A000, 0xF000F000,
         0x88008800, 0xCC00CC00, 0xAA00AA00, 0xFF00FF00,
         0x80808080, 0xC0C0C0C0, 0xA0A0A0A0, 0xF0F0F0F0,
         0x88888888, 0xCCCCCCCC, 0xAAAAAAAA, 0xFFFFFFFF],
        [0x80000000, 0xC0000000, 0x60000000, 0x90000000,
         0xE8000000, 0x5C000000, 0x8E000000, 0xC5000000,
         0x68800000, 0x9CC00000, 0xEE600000, 0x55900000,
         0x80680000, 0xC09C0000, 0x60EE0000, 0x90550000,
         0xE8808000, 0x5CC0C000, 0x8E606000, 0xC5909000,
         0x6868E800, 0x9C9C5C00, 0xEEEE8E00, 0x5555C500,
         0x8000E880, 0xC0005CC0, 0x60008E60, 0x9000C590,
         0xE8006868, 0x5C009C9C, 0x8E00EEEE, 0xC5005555],
        [0x80000000, 0xC0000000, 0x20000000, 0x50000000,
         0xF8000000, 0x74000000, 0xA2000000, 0x93000000,
         0xD8800000, 0x25400000, 0x59E00000, 0xE6D00000,
         0x78080000, 0xB40C0000, 0x82020000, 0xC3050000,
         0x208F8000, 0x51474000, 0xFBEA2000, 0x75D93000,
         0xA0858800, 0x914E5400, 0xDBE79E00, 0x25DB6D00,
         0x58800080, 0xE54000C0, 0x79E00020, 0xB6D00050,
         0x800800F8, 0xC00C0074, 0x200200A2, 0x50050093],
    ],
    dtype=np.uint32,
)


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


def u32_hash(value) -> jnp.ndarray:
    """PCG output hash (HalogenRandom.hlsl:110-115)."""
    v = _u32(value)
    state = v * _U32(747796405) + _U32(2891336453)
    word = ((state >> ((state >> _U32(28)) + _U32(4))) ^ state) * _U32(277803737)
    return (word >> _U32(22)) ^ word


def hash_combine(seed, v) -> jnp.ndarray:
    """Boost-style hash combine (HalogenRandom.hlsl:131-133)."""
    seed = _u32(seed)
    v = _u32(v)
    return seed ^ (v + (seed << _U32(6)) + (seed >> _U32(2)))


def reverse_bits_u32(x) -> jnp.ndarray:
    """Bit-reversal of a uint32 (HLSL `reversebits`)."""
    x = _u32(x)
    m1, m2, m4, m8 = (_U32(0x55555555), _U32(0x33333333),
                      _U32(0x0F0F0F0F), _U32(0x00FF00FF))
    x = ((x >> _U32(1)) & m1) | ((x & m1) << _U32(1))
    x = ((x >> _U32(2)) & m2) | ((x & m2) << _U32(2))
    x = ((x >> _U32(4)) & m4) | ((x & m4) << _U32(4))
    x = ((x >> _U32(8)) & m8) | ((x & m8) << _U32(8))
    return (x >> _U32(16)) | (x << _U32(16))


def owen_scramble(value, seed) -> jnp.ndarray:
    """Hash-based Owen scramble (HalogenRandom.hlsl:140-161).

    The improved Laine-Karras-style hash; used both to shuffle sample
    indices and to scramble sample values.
    """
    seed = _u32(seed)
    x = reverse_bits_u32(value)
    x = x ^ (x * _U32(0x3D20ADEA))
    x = x + seed
    x = x * ((seed >> _U32(16)) | _U32(1))
    x = x ^ (x * _U32(0x05526C56))
    x = x ^ (x * _U32(0x53A22864))
    return reverse_bits_u32(x)


def sobol1d(index, dim: int) -> jnp.ndarray:
    """Sobol point for one of the 4 tabulated dimensions
    (HalogenRandom.hlsl:178-185)."""
    index = _u32(index)
    x = jnp.zeros_like(index)
    for bit in range(32):
        mask = (index >> _U32(bit)) & _U32(1)
        x = x ^ (mask * _U32(int(_SOBOL_DIRECTIONS[dim, bit])))
    return x


def _seeded(dimension, seed):
    return _u32(seed) ^ u32_hash(dimension)


def u32_owen_scrambled_sobol_1d(index, dimension, seed) -> jnp.ndarray:
    """1D scrambled Sobol (HalogenRandom.hlsl:203-209).

    Matches the reference quirk: the 1D variant scrambles the value but does
    NOT shuffle the index (decorrelation is entirely via the seeded hash).
    """
    seed = _seeded(dimension, seed)
    return owen_scramble(sobol1d(index, 0), u32_hash(seed))


def u32_owen_scrambled_sobol_2d(index, dimension, seed):
    """2D shuffled+scrambled Sobol (HalogenRandom.hlsl:215-228)."""
    seed = _seeded(dimension, seed)
    shuffled = owen_scramble(_u32(index), seed)
    x = owen_scramble(sobol1d(shuffled, 0), hash_combine(seed, 0))
    y = owen_scramble(sobol1d(shuffled, 1), hash_combine(seed, 1))
    return x, y


def u32_owen_scrambled_sobol_4d(index, dimension, seed):
    """4D shuffled+scrambled Sobol (HalogenRandom.hlsl:235-250)."""
    seed = _seeded(dimension, seed)
    shuffled = owen_scramble(_u32(index), seed)
    return tuple(
        owen_scramble(sobol1d(shuffled, d), hash_combine(seed, d))
        for d in range(4)
    )


_INV_U32 = np.float32(1.0 / 4294967296.0)


def _to_unit_float(u: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> [0, 1) float32 (divide by 2^32, HalogenRandom.hlsl:258)."""
    return u.astype(jnp.float32) * _INV_U32


def ld_sample_1d(index, dimension, seed) -> jnp.ndarray:
    """Float low-discrepancy sample in [0,1) (HalogenRandom.hlsl:252-259)."""
    return _to_unit_float(u32_owen_scrambled_sobol_1d(index, dimension, seed))


def ld_sample_2d(index, dimension, seed):
    """2D float low-discrepancy sample (HalogenRandom.hlsl:261-268)."""
    x, y = u32_owen_scrambled_sobol_2d(index, dimension, seed)
    return _to_unit_float(x), _to_unit_float(y)


def ld_sample_4d(index, dimension, seed):
    """4D float low-discrepancy sample (HalogenRandom.hlsl:270-277)."""
    return tuple(_to_unit_float(u)
                 for u in u32_owen_scrambled_sobol_4d(index, dimension, seed))


# ---------------------------------------------------------------------------
# PRNG ablation path (OVERRIDE_SAMPLING_TO_PRNG, HalogenDefines.hlsl:9).
# Counter-based rather than stateful: event index folds into the hash, so
# replay stays deterministic without threading PRNG state through the loop.
# ---------------------------------------------------------------------------

def prng_sample_1d(index, dimension, seed) -> jnp.ndarray:
    """Counter-based PCG stand-in for `random_value()`
    (HalogenRandom.hlsl:99-102); decorrelated per (index, dimension, seed)."""
    h = u32_hash(hash_combine(hash_combine(_u32(seed), _u32(index)), _u32(dimension)))
    return _to_unit_float(h)


def prng_sample_2d(index, dimension, seed):
    h0 = hash_combine(hash_combine(_u32(seed), _u32(index)), _u32(dimension))
    return _to_unit_float(u32_hash(h0)), _to_unit_float(u32_hash(h0 ^ _U32(0x9E3779B9)))


def pixel_seed(pixel_index) -> jnp.ndarray:
    """Per-pixel sampler seed: PCG-hashed flat pixel id
    (HalogenRandom.hlsl:117-124)."""
    return u32_hash(pixel_index)


def sample_index(frame: jnp.ndarray | int, spp_idx, spp: int) -> jnp.ndarray:
    """Global sample index for (frame, spp lane) — the §3.4 redesign."""
    return _u32(frame) * _U32(spp) + _u32(spp_idx)
