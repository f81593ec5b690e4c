"""Nested-dielectric interface tracking as a data-parallel sorted stack.

A data-parallel redesign of the reference's per-thread `participatingMediumStack`
(`HalgoenCompute.compute:188-189,582-665`): each ray carries a fixed-depth
stack stored as SoA arrays; push/pop are branch-free vectorized shifts with
per-ray masks, so a whole wavefront updates in lockstep.

Semantics preserved exactly (priority rule and ordering):
- Lower priority value = higher precedence; the stack is kept sorted in
  DESCENDING priority value from bottom to top, so the top (index sp-1) is
  the highest-precedence medium (`add_to_medium_stack`, compute:582-622).
- Equal-priority media are appended above existing ones (stable).
- A hit is "true" iff the stack is empty or the hit material's priority <=
  top priority (`determine_true_medium_hit`, compute:656-665).
- Pop removes the first (bottom-most) entry whose materialID matches; a
  missing ID is a silent no-op (`pop_from_medium_stack`, compute:627-642).
- The empty medium has IOR 1, zero absorption, priority +inf, id -1
  (`get_empty_medium`, compute:80-88).
- Pushing onto a full stack is dropped (the reference leaves this as UB /
  TODO at compute:579; we clamp).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from halogen_tpu.core.types import EMPTY_PRIORITY, NO_MEDIUM_ID

STACK_DEPTH = 8  # participatingMediumStack[8] (HalgoenCompute.compute:188)

_EMPTY_IOR = np.float32(1.0)


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclasses.dataclass(frozen=True)
class Medium:
    """A batch of participating media ([N] leaves, [N,3] absorption)."""

    ior: jnp.ndarray
    absorption: jnp.ndarray
    priority: jnp.ndarray  # int32
    material_id: jnp.ndarray  # int32

    @staticmethod
    def empty(batch_shape) -> "Medium":
        return Medium(
            ior=jnp.full(batch_shape, _EMPTY_IOR, dtype=jnp.float32),
            absorption=jnp.zeros(batch_shape + (3,), dtype=jnp.float32),
            priority=jnp.full(batch_shape, EMPTY_PRIORITY, dtype=jnp.int32),
            material_id=jnp.full(batch_shape, NO_MEDIUM_ID, dtype=jnp.int32),
        )


@_register
@dataclasses.dataclass(frozen=True)
class MediumStack:
    """Per-ray medium stacks: [N, D] slots + [N] size pointer."""

    ior: jnp.ndarray  # [N, D]
    absorption: jnp.ndarray  # [N, D, 3]
    priority: jnp.ndarray  # [N, D] int32
    material_id: jnp.ndarray  # [N, D] int32
    size: jnp.ndarray  # [N] int32

    @staticmethod
    def create(n: int, depth: int = STACK_DEPTH) -> "MediumStack":
        return MediumStack(
            ior=jnp.full((n, depth), _EMPTY_IOR, dtype=jnp.float32),
            absorption=jnp.zeros((n, depth, 3), dtype=jnp.float32),
            priority=jnp.full((n, depth), EMPTY_PRIORITY, dtype=jnp.int32),
            material_id=jnp.full((n, depth), NO_MEDIUM_ID, dtype=jnp.int32),
            size=jnp.zeros((n,), dtype=jnp.int32),
        )

    @property
    def depth(self) -> int:
        return self.ior.shape[1]

    def _slots(self) -> jnp.ndarray:
        return jnp.arange(self.depth, dtype=jnp.int32)[None, :]  # [1, D]

    def top(self) -> Medium:
        """Highest-precedence medium, or the empty medium when the stack is
        empty (get_top_ray_medium, HalgoenCompute.compute:647-654)."""
        idx = jnp.maximum(self.size - 1, 0)  # [N]
        sel = self._slots() == idx[:, None]  # [N, D] one-hot
        nonempty = self.size > 0
        e = Medium.empty(self.size.shape)
        pick = lambda arr, empty_val: jnp.where(
            nonempty, jnp.sum(jnp.where(sel, arr, 0), axis=1), empty_val
        )
        ior = pick(self.ior.astype(jnp.float32), e.ior)
        prio = pick(self.priority, e.priority)
        mid = pick(self.material_id, e.material_id)
        absorb = jnp.where(
            nonempty[:, None],
            jnp.sum(jnp.where(sel[..., None], self.absorption, 0.0), axis=1),
            e.absorption,
        )
        return Medium(ior=ior, absorption=absorb, priority=prio, material_id=mid)

    def is_true_hit(self, priority: jnp.ndarray) -> jnp.ndarray:
        """Priority rule (determine_true_medium_hit, compute:656-665):
        true iff empty stack or priority <= top priority."""
        return (self.size == 0) | (priority <= self.top().priority)

    def push(self, medium: Medium, mask: jnp.ndarray) -> "MediumStack":
        """Sorted insertion where `mask` (add_to_medium_stack,
        compute:582-622). Keeps descending priority bottom->top; equal
        priorities insert above existing entries. Full stacks drop the push.
        """
        slots = self._slots()  # [1, D]
        top_prio = self.top().priority  # [N]
        # Insertion index: append at top when priority <= top (covers the
        # empty case: top of empty = +inf); otherwise the count of strictly
        # greater entries (stack is sorted, so that is the sorted position).
        greater = (slots < self.size[:, None]) & (
            self.priority > medium.priority[:, None]
        )
        idx_sorted = jnp.sum(greater.astype(jnp.int32), axis=1)
        at_top = medium.priority <= top_prio
        idx = jnp.where(at_top, self.size, idx_sorted)  # [N]

        can = mask & (self.size < self.depth)
        shift_up = (slots >= idx[:, None]) & can[:, None]  # [N, D]

        def place(arr, val):
            # arr [N, D(,3)], val [N(,3)]
            shifted = jnp.where(
                _expand(shift_up, arr),
                jnp.roll(arr, 1, axis=1),
                arr,
            )
            write = (slots == idx[:, None]) & can[:, None]
            return jnp.where(_expand(write, arr), _bcast(val, arr), shifted)

        return MediumStack(
            ior=place(self.ior, medium.ior),
            absorption=place(self.absorption, medium.absorption),
            priority=place(self.priority, medium.priority),
            material_id=place(self.material_id, medium.material_id),
            size=self.size + can.astype(jnp.int32),
        )

    def pop_id(self, material_id: jnp.ndarray, mask: jnp.ndarray) -> "MediumStack":
        """Remove the bottom-most entry matching material_id where `mask`
        (pop_from_medium_stack, compute:627-642). Missing ID = no-op."""
        slots = self._slots()
        match = (slots < self.size[:, None]) & (
            self.material_id == material_id[:, None]
        )  # [N, D]
        found = jnp.any(match, axis=1)
        # argmax finds the first (lowest-index) match
        first = jnp.argmax(match, axis=1).astype(jnp.int32)
        do = mask & found
        shift_down = (slots >= first[:, None]) & do[:, None]

        def remove(arr, fill):
            shifted = jnp.where(
                _expand(shift_down, arr), jnp.roll(arr, -1, axis=1), arr
            )
            # Clear the now-dead top slot
            dead = (slots == (self.size - 1)[:, None]) & do[:, None]
            return jnp.where(_expand(dead, arr), fill, shifted)

        return MediumStack(
            ior=remove(self.ior, _EMPTY_IOR),
            absorption=remove(self.absorption, 0.0),
            priority=remove(self.priority, EMPTY_PRIORITY),
            material_id=remove(self.material_id, NO_MEDIUM_ID),
            size=self.size - do.astype(jnp.int32),
        )


def _expand(mask2d: jnp.ndarray, like: jnp.ndarray) -> jnp.ndarray:
    return mask2d[..., None] if like.ndim == 3 else mask2d


def _bcast(val: jnp.ndarray, like: jnp.ndarray) -> jnp.ndarray:
    return val[:, None, :] if like.ndim == 3 else val[:, None]
