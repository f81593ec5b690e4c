"""Numerical debugging (SURVEY.md §5.2): this build's substitute for
race detection/sanitizers — the renderer is functionally pure, so the
failure modes that matter are NaN/Inf leaks and nondeterminism, checked
directly."""

from __future__ import annotations

import contextlib

import numpy as np
import jax


@contextlib.contextmanager
def nan_guard():
    """Enable jax_debug_nans within the scope: any NaN-producing op raises
    at the op, with a traceback into the integrator."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def assert_finite(tree, name: str = "output"):
    """Raise if any leaf contains NaN/Inf (post-hoc render validation)."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}{jax.tree_util.keystr(path)}: {bad} non-finite values"
            )


def check_replay_determinism(render_fn, *args, repeats: int = 2) -> bool:
    """Run `render_fn(*args)` `repeats` times and assert bitwise-identical
    results — the determinism contract that path-replay gradients and
    placement-invariant sharding rest on (SURVEY.md §3.4)."""
    ref = np.asarray(render_fn(*args))
    for _ in range(repeats - 1):
        out = np.asarray(render_fn(*args))
        np.testing.assert_array_equal(out, ref)
    return True
