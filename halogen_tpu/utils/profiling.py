"""Profiling hooks (SURVEY.md §5.1 — the equivalent of the reference's
ProfilingScope + RenderDoc workflow): jax.profiler trace capture around
render calls, plus a timed-section helper feeding the metrics logger."""

from __future__ import annotations

import contextlib
import time

import jax

from halogen_tpu.utils.metrics import get_logger


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/halogen_trace"):
    """Capture a jax.profiler trace (view in TensorBoard / xprof).

    Usage:
        with profiling.trace("/tmp/trace"):
            render_frame(...).block_until_ready()
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        get_logger().info("profiler trace written to %s", log_dir)


@contextlib.contextmanager
def timed(label: str, rays: int | None = None):
    """Wall-time a block; logs Mrays/s when `rays` is given (the HUD
    metric, HalogenRenderFeature.cs:97)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if rays is not None:
            get_logger().info("%s: %.3fs (%.1f Mrays/s)", label, dt,
                              rays / dt / 1e6)
        else:
            get_logger().info("%s: %.3fs", label, dt)


def annotate(name: str):
    """Named region for the profiler timeline (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)
