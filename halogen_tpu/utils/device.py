"""What a measurement ran on: JAX's device description and the card's
name and power limit as `nvidia-smi` reports them.

Every timed result names its device, so that a number from a CPU run is
never read as a GPU number, and a card held below its power limit is
visible beside the numbers it produced.
"""

from __future__ import annotations

import subprocess


def device_info() -> dict:
    """{"platform", "kind", "count"} of the default JAX backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output, one line per
    card. Raises if the tool is missing or fails (no card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
