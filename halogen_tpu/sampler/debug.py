"""Sampler distribution visualizer (component #5, SURVEY.md §2).

The equivalent of `Debug/DebugSobol.compute` + `HalogenDebugger.cs`: plots
N Owen-scrambled Sobol points through the Blackman-Harris inverse CDF into
a 2D histogram image to visually validate the sampler and pixel-filter
distributions (DebugSobol.compute:19-41 splats 100k samples around the
texture center). Vectorized: one histogram scatter-add instead of a
single-thread loop.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from halogen_tpu.sampler.sobol import ld_sample_2d
from halogen_tpu.sampler.mappings import inverse_blackman_harris_cdf


def sobol_filter_image(size: int = 256, count: int = 100_000,
                       seed: int = 0, spread: float = 0.45,
                       through_filter: bool = True) -> np.ndarray:
    """[size, size, 3] density plot of `count` Sobol points.

    through_filter=True maps each sample through the Blackman-Harris
    inverse CDF around the image center (the DebugSobol behavior);
    False plots the raw [0,1)^2 points (stratification check).
    """
    idx = jnp.arange(count, dtype=jnp.uint32)
    u, v = ld_sample_2d(idx, jnp.uint32(0), jnp.uint32(seed))
    if through_filter:
        # invBH maps to ~[-0.5, 0.5]; scale into the image around center
        x = 0.5 + inverse_blackman_harris_cdf(u) * 2.0 * spread
        y = 0.5 + inverse_blackman_harris_cdf(v) * 2.0 * spread
    else:
        x, y = u, v
    xi = jnp.clip((x * size).astype(jnp.int32), 0, size - 1)
    yi = jnp.clip((y * size).astype(jnp.int32), 0, size - 1)
    hist = jnp.zeros((size * size,), jnp.float32).at[yi * size + xi].add(1.0)
    hist = np.asarray(hist.reshape(size, size))
    peak = hist.max() if hist.max() > 0 else 1.0
    img = (hist / peak)[..., None].repeat(3, axis=-1)
    return img.astype(np.float32)


def sobol_discrepancy_probe(count: int = 4096, dims=(0, 5, 10),
                            seed: int = 1):
    """Quick numeric probe: per-dimension-pair star-ish discrepancy proxy
    (mean squared deviation of box counts) for test assertions."""
    idx = jnp.arange(count, dtype=jnp.uint32)
    out = {}
    for d in dims:
        u, v = ld_sample_2d(idx, jnp.uint32(d), jnp.uint32(seed))
        # 16x16 stratification counts should be near-uniform
        h = jnp.zeros((256,), jnp.int32).at[
            (jnp.clip((v * 16).astype(jnp.int32), 0, 15) * 16
             + jnp.clip((u * 16).astype(jnp.int32), 0, 15))
        ].add(1)
        expected = count / 256.0
        out[d] = float(jnp.mean((h - expected) ** 2) / expected)
    return out
