"""Test harness config: force CPU JAX with an 8-device virtual mesh.

The tests run on the CPU; sharding tests run on a virtual 8-device CPU mesh.
What only a GPU can run is exercised by chip_smoke.py. Must run before jax
import.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

# jax may already have been imported (e.g. by a plugin) before this file runs,
# in which case the env var alone is too late — update the live config too.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

