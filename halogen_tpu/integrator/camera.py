"""Thin-lens camera ray generation with Blackman-Harris pixel filtering.

A vectorized re-implementation of the reference's `get_ray` / `get_ray_jitter`
(`HalgoenCompute.compute:984-1013`): pinhole frustum defined by
half-width/half-height at the near plane (ViewParameters,
`HalogenRenderPass.cs:359-368`), thin-lens aperture sampling on a focal
disc of radius tan(apertureAngle) * near, filter-importance-sampled pixel
jitter through the inverted Blackman-Harris CDF.

Deliberate fix vs the reference (documented deviation): the reference
samples the pixel at its corner (uv = id / res, compute:1023) and its
jitter is asymmetric around -filterRadius (compute:991-992 subtracts 0.5
from the already-centered CDF inverse), producing a systematic ~1-pixel
image shift. Here rays target pixel centers and the jitter is centered:
jitter = invBH(u) * 2 * filterRadius * pixelSize, spanning ±filterRadius
pixels with Blackman-Harris weighting.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from halogen_tpu.core.math import (
    normalize,
    stack3,
    transform_dir,
    transform_point,
)
from halogen_tpu.sampler.sobol import (
    DIM_FOCAL_DISC,
    DIM_RAY_JITTER,
)
from halogen_tpu.sampler.mappings import (
    inverse_blackman_harris_cdf,
    point_in_circle,
)


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera pytree: all leaves are arrays so moving the camera never
    retriggers compilation (the reference re-binds uniforms per dispatch,
    HalogenRenderPass.cs:366-369)."""

    cam_to_world: jnp.ndarray  # [4, 4]
    half_w: jnp.ndarray  # frustum half-width at near plane
    half_h: jnp.ndarray
    near: jnp.ndarray
    far: jnp.ndarray
    focal_distance: jnp.ndarray
    aperture_radius: jnp.ndarray  # tan(apertureAngle) * near


def look_at_matrix(position, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Right-handed look-at: camera looks down +z in camera space (the
    reference's frustum ray z is +near, compute:1002)."""
    position = np.asarray(position, np.float64)
    fwd = np.asarray(target, np.float64) - position
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, np.float64)
    # Camera space: +x right (on screen), +y up, +z forward. Facing fwd
    # with world-up upv, screen-right is fwd x up.
    right = np.cross(fwd, upv)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = fwd
    m[:3, 3] = position
    return m.astype(np.float32)


def make_camera(
    position=(0.0, 0.0, 3.5),
    target=(0.0, 0.0, 0.0),
    up=(0.0, 1.0, 0.0),
    fov_deg: float = 60.0,
    aspect: float = 1.0,
    near: float = 0.1,
    far: float = 5000.0,
    focal_distance: float | None = None,
    aperture_deg: float = 0.0,
) -> Camera:
    """Build a Camera. Defaults mirror the shipped URP settings (fov 60,
    near 0.1, far 5000, aperture 0 — SURVEY.md §5.6)."""
    half_h = float(np.tan(np.deg2rad(fov_deg) * 0.5) * near)
    half_w = aspect * half_h
    if focal_distance is None:
        focal_distance = float(
            np.linalg.norm(np.asarray(target, np.float64)
                           - np.asarray(position, np.float64))
        )
    aperture_deg = float(np.clip(aperture_deg, 0.0, 89.9))
    return Camera(
        cam_to_world=jnp.asarray(look_at_matrix(position, target, up)),
        half_w=jnp.float32(half_w),
        half_h=jnp.float32(half_h),
        near=jnp.float32(near),
        far=jnp.float32(far),
        focal_distance=jnp.float32(max(focal_distance, 1e-6)),
        aperture_radius=jnp.float32(np.tan(np.deg2rad(aperture_deg)) * near),
    )


def generate_rays(
    camera: Camera,
    pixel_x: jnp.ndarray,
    pixel_y: jnp.ndarray,
    width: int,
    height: int,
    filter_radius: float,
    sample_idx: jnp.ndarray,
    seed: jnp.ndarray,
    sample_2d,
):
    """Primary rays for flat pixel arrays.

    pixel_x/pixel_y: [N] int pixel coordinates (x right, y up);
    sample_idx/seed: [N] uint32 sampler inputs; sample_2d: the active
    sampler's 2D draw fn. Returns (origins [N,3], directions [N,3]).
    """
    # Pixel center NDC in [-1, 1]
    ndc_x = ((pixel_x.astype(jnp.float32) + 0.5) / width) * 2.0 - 1.0
    ndc_y = ((pixel_y.astype(jnp.float32) + 0.5) / height) * 2.0 - 1.0

    # Blackman-Harris jitter, centered (see module docstring), in camera units
    px_w = 2.0 * camera.half_w / width
    px_h = 2.0 * camera.half_h / height
    ju, jv = sample_2d(sample_idx, DIM_RAY_JITTER, seed)
    jitter_x = inverse_blackman_harris_cdf(ju) * 2.0 * filter_radius * px_w
    jitter_y = inverse_blackman_harris_cdf(jv) * 2.0 * filter_radius * px_h

    screen = stack3(
        ndc_x * camera.half_w + jitter_x,
        ndc_y * camera.half_h + jitter_y,
        jnp.broadcast_to(camera.near, ndc_x.shape),
    )  # camera space point on the near plane (compute:1002-1003)

    # Thin lens: aperture point on the focal disc (compute:998-999)
    au, av = sample_2d(sample_idx, DIM_FOCAL_DISC, seed)
    ax, ay = point_in_circle(camera.aperture_radius, au, av)
    aperture = stack3(ax, ay, jnp.zeros_like(ax))

    # Direction through the focal plane (compute:1006-1007)
    focal_point = normalize(screen) * camera.focal_distance
    cam_dir = normalize(focal_point - aperture)

    origin = transform_point(camera.cam_to_world, aperture)
    direction = normalize(transform_dir(camera.cam_to_world, cam_dir))
    return origin, direction
