"""Halogen: a differentiable path tracer in JAX (XLA).

Brand-new framework with the capabilities of the reference Unity/HLSL renderer
Kabinet0/Halogen-Pathtracer (see SURVEY.md): BVH-accelerated triangle meshes and
analytic spheres, Owen-scrambled Sobol sampling, Blackman-Harris pixel filtering,
thin-lens focal blur, environment maps, diffuse/specular/metallic/roughness
materials, emission, refraction with nested dielectrics (priority interface
tracking), Beer-Lambert absorption, per-ray-type bounce limits, Russian roulette,
progressive accumulation, and debug views — plus differentiability and
multi-device sharding which the reference lacks.
"""

from halogen_tpu.config import (
    DebugMode,
    Intersector,
    RenderSettings,
    SamplerKind,
)
from halogen_tpu.scene.material import Material
from halogen_tpu.scene.scene import Scene
from halogen_tpu.scene.envmap import Envmap
from halogen_tpu.integrator.camera import Camera, make_camera
from halogen_tpu.integrator.trace import render_frame, render_pixels
from halogen_tpu.render.accumulate import Renderer, RenderState

__version__ = "0.1.0"

__all__ = [
    "RenderSettings",
    "DebugMode",
    "Intersector",
    "SamplerKind",
    "Material",
    "Scene",
    "Envmap",
    "Camera",
    "make_camera",
    "render_frame",
    "render_pixels",
    "Renderer",
    "RenderState",
]
