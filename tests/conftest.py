"""Test configuration: the tests run on the CPU backend, with 8 virtual
devices so multi-device sharding is exercised without a GPU
(SURVEY.md §4d):

    JAX_PLATFORMS=cpu python -m pytest tests/ -m "not slow"

The backend is also selected through jax.config here, before any backend
is initialized, so the tests stay on the CPU even where a GPU is visible.
Nothing in the test suite needs the GPU. On a machine with an NVIDIA GPU,
`python chip_smoke.py` (at the repo root) is the check that the main path
runs there, compiled for the card, and agrees with the CPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
