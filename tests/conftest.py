"""Test configuration: by default everything runs on a virtual 8-device
CPU mesh.

Sharding correctness is validated on XLA's host platform with 8 virtual
devices. JAX_PLATFORMS defaults to cpu here; the on-card tests (marker
``gpu``, tests/test_gpu.py) run with JAX_PLATFORMS=cuda,cpu on a machine
with a GPU and skip elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from sp_coupler.runtime import compile_cache  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)

# Persistent compilation cache: the driver tests build many structurally
# identical XLA programs (same T10/L8 GCM + 16x16x24 LES shapes in fresh
# SPRunner/CoupledStepFn instances), each of which would recompile from
# scratch — the dominant cost of the fast tier on a small host. The disk
# cache dedupes them within AND across sessions and xdist workers; it
# lives where JAX_COMPILATION_CACHE_DIR says, else in the checkout.
compile_cache.configure()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
