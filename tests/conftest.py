"""Test configuration: run everything on CPU with 8 virtual devices.

Mirrors the idiomatic JAX multi-device test setup: sharded tests exercise a
virtual 8-device mesh (`--xla_force_host_platform_device_count=8`) instead
of real hardware — the analogue of a fake backend.  Must run before any
jax import, hence the env mutation at module import time.  The suite and
the CLI processes it starts share one compile cache inside the checkout
(listed in .gitignore).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".test_cache"),
)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where there is none "
        "(make test-gpu)")
