"""Progressive accumulation driver + checkpointing.

The equivalent of the reference's render-pass state machine
(`HalogenRenderPass.cs:270-357` + `AccumulationShader.shader:27-34`): each
step renders one frame and folds it into the running mean with weight
1/FrameCount (an exact incremental mean), stopping after
`max_accumulated_frames` unless `unlimited_sampling`. The accumulator +
frame counter form an explicit checkpointable pytree (SURVEY.md §5.4) —
the reference's resumable state was implicit in its GPU textures; here a
long render or inverse-rendering run can be saved/resumed via npz.

Invalidation mirrors the reference: camera moves or resolution changes
reset accumulation (`HalogenRenderPass.cs:254-257,279-291`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from halogen_tpu.config import RenderSettings
from halogen_tpu.core.types import SceneData
from halogen_tpu.integrator.camera import Camera
from halogen_tpu.integrator.trace import render_frame


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclasses.dataclass(frozen=True)
class RenderState:
    """Checkpointable progressive-render state."""

    accum: jnp.ndarray  # [H, W, 3] running mean (the back buffer)
    frame_count: jnp.ndarray  # int32, starts at 1 like the reference

    @staticmethod
    def create(settings: RenderSettings) -> "RenderState":
        return RenderState(
            accum=jnp.zeros((settings.height, settings.width, 3), jnp.float32),
            frame_count=jnp.int32(1),
        )


@jax.jit
def _blend(accum: jnp.ndarray, frame: jnp.ndarray, frame_count: jnp.ndarray):
    """out = accum*(1-w) + frame*w, w = 1/FrameCount
    (AccumulationShader.shader:33, weight at HalogenRenderPass.cs:330)."""
    w = 1.0 / frame_count.astype(jnp.float32)
    return accum * (1.0 - w) + frame * w


def accumulate_step(
    state: RenderState,
    scene: SceneData,
    camera: Camera,
    settings: RenderSettings,
) -> RenderState:
    """One progressive frame (Execute, HalogenRenderPass.cs:270-357)."""
    frame_idx = state.frame_count if settings.accumulate else jnp.int32(1)
    frame = render_frame(scene, camera, settings, frame_idx.astype(jnp.uint32))
    if not settings.accumulate:
        return RenderState(accum=frame, frame_count=jnp.int32(1))
    return RenderState(
        accum=_blend(state.accum, frame, state.frame_count),
        frame_count=state.frame_count + 1,
    )


class Renderer:
    """Host-side progressive renderer with reference reset semantics."""

    def __init__(self, scene: SceneData, camera: Camera,
                 settings: RenderSettings):
        self.scene = scene
        self.camera = camera
        self.settings = settings
        self.state = RenderState.create(settings)
        self._cam_fingerprint = self._fingerprint(camera)

    @staticmethod
    def _fingerprint(camera: Camera):
        return np.asarray(camera.cam_to_world).tobytes()

    def set_camera(self, camera: Camera):
        fp = self._fingerprint(camera)
        if fp != self._cam_fingerprint:  # camera moved -> clear accumulation
            self.reset()
        self.camera = camera
        self._cam_fingerprint = fp

    def reset(self):
        self.state = RenderState.create(self.settings)

    @property
    def done(self) -> bool:
        """Accumulation-complete latch (HalogenRenderPass.cs:307)."""
        return (not self.settings.unlimited_sampling) and (
            int(self.state.frame_count) > self.settings.max_accumulated_frames
        )

    def step(self) -> np.ndarray:
        """Render/accumulate one frame (no-op once done); returns the
        current image."""
        if not self.done:
            self.state = accumulate_step(
                self.state, self.scene, self.camera, self.settings
            )
        return self.image

    def render(self, frames: Optional[int] = None) -> np.ndarray:
        """Accumulate `frames` frames (default: max_accumulated_frames)."""
        n = frames if frames is not None else self.settings.max_accumulated_frames
        for _ in range(n):
            if self.done:
                break
            self.step()
        return self.image

    @property
    def image(self) -> np.ndarray:
        return np.asarray(self.state.accum)

    # -- checkpointing (SURVEY.md §5.4) ---------------------------------
    def save_checkpoint(self, path: str):
        np.savez(
            path,
            accum=np.asarray(self.state.accum),
            frame_count=np.asarray(self.state.frame_count),
        )

    def load_checkpoint(self, path: str):
        data = np.load(path)
        self.state = RenderState(
            accum=jnp.asarray(data["accum"]),
            frame_count=jnp.asarray(data["frame_count"], jnp.int32),
        )
