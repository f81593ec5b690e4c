"""Render configuration.

The JAX equivalent of the reference's two config tiers (SURVEY.md §5.6):
the `HalogenSettings` runtime config (reference
`Render Features/HalogenRenderFeature.cs:24-67`) and the compile-time flag
header (`Halogen Shaders/HalogenDefines.hlsl:4-10`). Everything here is a
static (hashable) jit argument: changing a setting triggers recompilation,
exactly like the reference snapshots settings at pass construction
(`HalogenRenderPass.cs:154-233`).
"""

from __future__ import annotations

import dataclasses
import enum


class DebugMode(enum.IntEnum):
    """Debug render views (reference `HalogenRenderFeature.cs:6-13`)."""

    NONE = 0
    ALBEDO = 1
    NORMAL = 2
    RAY_TRIANGLE_TESTS = 3
    RAY_BOX_TESTS = 4
    COMBINED = 5


class SamplerKind(enum.IntEnum):
    """Sampler selection — Owen-scrambled Sobol, or PCG PRNG ablation
    (reference `HalogenDefines.hlsl:9` OVERRIDE_SAMPLING_TO_PRNG)."""

    SOBOL = 0
    PRNG = 1


class Intersector(enum.IntEnum):
    """Scene-intersection backend.

    AUTO selects BRUTE (a regular rays x triangle-tiles scan with no
    per-ray control flow) up to `RenderSettings.brute_force_max_tris`
    triangles and the lockstep BVH traversal above it, on every backend.
    The reference has only a per-mesh BVH path
    (`HalgoenCompute.compute:378-472`).
    """

    AUTO = 0
    BRUTE = 1
    BVH = 2


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render settings (one compiled executable per distinct value).

    Field-by-field parity with reference `HalogenSettings`
    (`HalogenRenderFeature.cs:24-67`) plus the compile-time flags from
    `HalogenDefines.hlsl`. Shipped defaults follow
    `Assets/URP-HighFidelity-Renderer.asset`.
    """

    # Image (static: defines array shapes)
    width: int = 256
    height: int = 256

    # Sampling
    samples_per_pixel: int = 1
    max_accumulated_frames: int = 16
    unlimited_sampling: bool = True
    accumulate: bool = True

    # Bounces (a limit of N allows N+1 interactions of that type before
    # termination — reference `HalgoenCompute.compute:869-871` uses `>`)
    max_bounces: int = 12
    max_diffuse_bounces: int = 4
    max_glossy_bounces: int = 4
    max_transmission_bounces: int = 12

    # Film
    filter_radius: float = 1.0  # in pixels

    # Environment
    use_envmap: bool = False
    env_mip_level: int = 1  # clamped [0, 2] like HalogenRenderPass.cs:183
    # Real envmap importance sampling: per-diffuse-bounce next-event
    # estimation from the luminance CDF, MIS-combined (balance heuristic)
    # with the cosine BRDF sampling. Capability beyond the reference (its
    # MIS TODO, HalgoenCompute.compute:19). Costs one extra scene
    # intersection per bounce.
    env_importance_sampling: bool = False
    # Area-light next-event estimation: per-diffuse-bounce sample of an
    # emissive triangle (power-proportional CDF), MIS-combined with the
    # cosine continuation. Capability beyond the reference (whose small
    # Cornell panel is found only by chance). Costs one extra scene
    # intersection per bounce.
    light_importance_sampling: bool = False

    # Compile-time flags (HalogenDefines.hlsl:4-10)
    mip_importance_bias: bool = True  # QUESTIONABLE_IMPORTANCE_SAMPLING
    mip_importance_range: float = 8.0  # QUESTIONABLE_IMPORTANCE_SAMPLING_RANGE
    sampler: SamplerKind = SamplerKind.SOBOL
    russian_roulette: bool = True  # !OVERRIDE_DISABLE_RUSSIAN_ROULETTE

    # Debug
    debug_mode: DebugMode = DebugMode.NONE
    first_interaction_only: bool = False
    triangle_debug_display_range: int = 64
    box_debug_display_range: int = 64

    # Execution knobs (no reference counterpart)
    intersector: Intersector = Intersector.AUTO
    # Wavefront scheduler (SURVEY.md §2 #14): compact active rays per
    # bounce and run only live blocks. Forward-only (no grad); best for
    # deep-bounce scenes with Russian roulette. Off = lockstep masking.
    wavefront: bool = False
    wavefront_block: int = 8192  # rays per wavefront dispatch block
    ray_chunk_size: int = 65536  # rays traced per inner step (memory bound)
    triangle_block: int = 128  # brute-force triangle tile
    brute_force_max_tris: int = 4096  # AUTO picks BVH above this

    def __post_init__(self):
        clamp = lambda name, lo, hi=None: object.__setattr__(
            self, name, max(lo, getattr(self, name)) if hi is None
            else min(hi, max(lo, getattr(self, name))))
        # Defensive clamping mirrors HalogenRenderPass.cs:169-233
        clamp("samples_per_pixel", 1)
        clamp("max_bounces", 0)
        clamp("max_diffuse_bounces", 0)
        clamp("max_glossy_bounces", 0)
        clamp("max_transmission_bounces", 0)
        clamp("filter_radius", 0.0)
        clamp("max_accumulated_frames", 1)
        clamp("env_mip_level", 0, 2)
        clamp("triangle_debug_display_range", 1)
        clamp("box_debug_display_range", 1)
        if self.debug_mode != DebugMode.NONE and self.first_interaction_only:
            object.__setattr__(self, "max_bounces", 0)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)
