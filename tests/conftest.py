"""Test configuration: an 8-device virtual CPU mesh before JAX is used.

The tests run on the CPU (``JAX_PLATFORMS=cpu``); sharding tests use the
virtual devices that ``--xla_force_host_platform_device_count`` gives the
CPU backend.  The platform is also pinned through ``jax.config`` so that it
holds whatever the environment sets.  GPU runs go through
``chip_smoke.py`` (see README).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# persistent compilation cache: makes repeated test runs cheap
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

import jax  # noqa: E402

if os.environ.get("DCS_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

from dcsexplorer_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
