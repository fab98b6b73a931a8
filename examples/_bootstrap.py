"""Shared example prologue: the repo root on ``sys.path``, and 8 virtual
CPU devices when the examples run on the CPU (``JAX_PLATFORMS=cpu``) so
``sharded_example.py`` exercises a real mesh without hardware (the
tests/conftest.py pattern).  The platform itself follows ``JAX_PLATFORMS``.

Importing this module must happen BEFORE the first jax backend use (the
device count is latched at backend init).
"""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

if os.environ.get("JAX_PLATFORMS") == "cpu":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
