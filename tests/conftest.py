"""Test environment: force an 8-device virtual CPU mesh.

Multi-device sharding is validated on virtual CPU devices (SURVEY.md
section 4 'Implication for the rebuild'); Pallas kernels run in the
interpreter here. What only runs on the GPU is a phase of chip_smoke.py.
The platform is selected through jax.config before any backend exists.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from garden_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "float32")
# persistent compile cache: the suite is dominated by per-test jit compiles
# on CPU; caching them across runs shortens repeat runs
enable_compile_cache(min_compile_secs=0.5)


def pytest_report_header(config):
    return f"jax backend: {jax.default_backend()}, devices: {len(jax.devices())}"
