"""Test harness config: force the CPU backend with 8 virtual devices so
multi-chip sharding tests run anywhere (the TPU translation of the reference's
MG test harness bootstrapping MPI+NCCL, cpp/tests/utilities/mg_utilities.cpp:19-46
— here jax's simulated multi-device CPU platform replaces real chips)."""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

# Hundreds of XLA:CPU JIT compiles in one process each mmap code pages; the
# default vm.max_map_count=65530 ceiling is hit mid-suite (~11k maps/min
# measured) and manifests as a segfault inside compilation. Raise it when
# possible; harmless no-op without privileges (the suite then needs splitting).
def _raise_max_map_count(target=1_000_000):
    path = "/proc/sys/vm/max_map_count"
    try:
        with open(path) as f:
            if int(f.read()) >= target:
                return
        with open(path, "w") as f:
            f.write(str(target))
    except (OSError, ValueError):
        pass


_raise_max_map_count()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: large-scale tests (RMAT-18+); run with CUGRAPH_TPU_RUN_SLOW=1")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card; skips without one")


def pytest_collection_modifyitems(config, items):
    import pytest

    if os.environ.get("CUGRAPH_TPU_RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow; set CUGRAPH_TPU_RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
