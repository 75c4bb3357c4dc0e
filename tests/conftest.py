"""Test configuration: force CPU with 8 virtual devices so multi-device
sharding tests run without a GPU (SURVEY.md §4c).

Note: some environments pre-import jax via pytest plugins, so the env var
alone is not enough — we also update jax.config before any backend is
initialized.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compile cache: the long-period FST4 decode tests compile
# multi-minute XLA programs (21.6 M-sample windows); cache makes those
# one-time per machine so the suite stays fast on re-runs.
from cwsl_digi_tpu import jaxcache  # noqa: E402

jaxcache.enable()
