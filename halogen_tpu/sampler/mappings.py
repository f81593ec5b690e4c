"""Sample warps and the pixel reconstruction filter.

Vectorized re-implementations of the warps in `Halogen Shaders/HalogenRandom.hlsl`:
uniform sphere direction (`:282-298`), uniform disc point (`:303-308`), and
the Blackman-Harris filter + inverse-CDF approximation (`:314-330`).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from halogen_tpu.core.math import stack3

_PI = np.float32(np.pi)
_TWO_PI = np.float32(2.0 * np.pi)


def unit_vector_from_2d(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Uniform direction on the unit sphere from two [0,1) samples
    (HalogenRandom.hlsl:282-298). Returns [..., 3]."""
    theta = u * _TWO_PI
    cos_phi = 2.0 * v - 1.0
    # acos then sin/cos of phi == direct construction:
    sin_phi = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_phi * cos_phi))
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    return stack3(sin_phi * cos_t, sin_phi * sin_t, cos_phi)


def point_in_circle(radius, u: jnp.ndarray, v: jnp.ndarray):
    """Point inside a disc of `radius` (HalogenRandom.hlsl:303-308).

    Matches the reference's non-uniform (center-heavy) warp: the radial
    coordinate is linear in the sample, not sqrt — aperture bokeh therefore
    concentrates toward the disc center, as in the reference.
    """
    theta = u * _TWO_PI
    r = radius * v
    return jnp.cos(theta) * r, jnp.sin(theta) * r


def blackman_harris_filter(x: jnp.ndarray, width) -> jnp.ndarray:
    """Blackman-Harris window evaluated at x in [0, width]
    (HalogenRandom.hlsl:314-317)."""
    phi = _TWO_PI * (x / width)
    return (
        0.35875
        - 0.48829 * jnp.cos(phi)
        + 0.14128 * jnp.cos(2.0 * phi)
        - 0.01168 * jnp.cos(3.0 * phi)
    )


def _arctanh(x: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * jnp.log((1.0 + x) / (1.0 - x))


def inverse_blackman_harris_cdf(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse-transform sampling of the Blackman-Harris distribution via the
    reference's analytic CDF-inverse approximation
    (HalogenRandom.hlsl:328-330). Maps [0,1) -> ~[-0.5, 0.5], centered at 0.
    """
    return _arctanh(x * 1.99221575606 - 0.99610787803) / 6.24
