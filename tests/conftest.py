"""Test configuration: run on the CPU with 8 virtual devices.

Mirrors the standard JAX fake-backend pattern so mesh/sharding tests run
without several accelerators (the reference has no distributed tests at
all; SURVEY.md section 4 calls this out as the gap to fill). Tests that
need the card carry the ``gpu`` marker and skip here; ``python
chip_smoke.py`` runs them on the card.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

from whvi_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# persistent compile cache: repeat test runs skip recompilation
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

assert jax.default_backend() == "cpu", jax.default_backend()
assert jax.device_count() == 8, jax.devices()
