"""Test configuration: CPU backend, 8 virtual devices, float64 enabled.

Must set env vars before jax initializes (SURVEY §4.8: fake an 8-device mesh
via --xla_force_host_platform_device_count for multi-chip tests without
hardware).
"""
import os

# Overwrite (not setdefault): the tests run on the CPU whatever the
# environment selects — a GPU would make every tiny test op a device
# compile, and several xdist workers would contend for one card.
# jax.config.update before first backend use pins the CPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent CPU compilation cache (r5 suite diet): the suite is compile-
# bound and its shapes are stable across runs, so repeat runs on the same
# box skip most XLA work.  Safe to delete; first run repopulates it.
# User-scoped path: a fixed /tmp name on a shared box would be owned by
# whoever ran first (write failures + cross-user poisoning).
import getpass  # noqa: E402

_cache_default = os.path.join(
    os.environ.get("TMPDIR", "/tmp"),
    f"jwave_test_comp_cache_{getpass.getuser()}")
jax.config.update("jax_compilation_cache_dir",
                  os.environ.get("JWAVE_TEST_CACHE_DIR", _cache_default))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
assert jax.devices()[0].platform == "cpu", jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run @pytest.mark.slow suites (sharded/HLO compile-heavy); "
             "also enabled by JWAVE_TEST_SLOW=1")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("JWAVE_TEST_SLOW"):
        return
    skip = pytest.mark.skip(
        reason="slow suite — run with --runslow (or JWAVE_TEST_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(42)
