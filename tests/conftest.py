"""Test configuration: run everything on a virtual 8-device CPU mesh.

``JAX_PLATFORMS`` picks another backend when it is set before pytest starts:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the tests marked
``gpu`` on the card (they skip on the CPU).

Must set the env vars before jax initialises its backends, so this executes at
conftest import time (pytest loads conftest before test modules).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Keep compilation deterministic and quiet in tests.
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

# Pin the config too, in case a pytest plugin imported jax before the env var
# was set.  Backends are lazy, so this holds until the first device query.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first JAX device, which must be a GPU; skips the test elsewhere."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled-program memory between test modules.

    The XLA CPU compiler segfaults after ~dozens of large program
    compilations in one process (reproduced on the slow e2e suite, jax
    backend_compile_and_load); dropping the executable cache between modules
    keeps the process under the threshold.
    """
    yield
    jax.clear_caches()
