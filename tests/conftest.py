"""Test environment: force a deterministic 8-device CPU mesh.

Must run before any jax import: tests validate bit-exactness and sharding
invariance on virtual CPU devices, with Pallas kernels in interpret mode;
the GPU path is exercised by chip_smoke.py.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

from versatilefilmgrain_tpu.utils.compile_cache import \
    setup_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
setup_compile_cache()
