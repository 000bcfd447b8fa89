import os
import sys
import tempfile

# tests run on the single real CPU device (the dry-run, and only the
# dry-run, forces 512 host devices in its own process)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# the FL integration tests build many small engines that jit the same
# round programs; the persistent cache deserializes repeat compilations
# (including across pytest runs) instead of re-lowering them
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(tempfile.gettempdir(), "repro-jax-cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# repo root, for tests that exercise the benchmarks package
sys.path.insert(1, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running FL integration test "
        "(deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


class FakeMesh:
    """Duck-typed mesh for sharding-rule unit tests (no devices needed)."""

    def __init__(self, shape_by_axis):
        self.axis_names = tuple(shape_by_axis)
        self.shape = dict(shape_by_axis)


@pytest.fixture
def mesh16x16():
    return FakeMesh({"data": 16, "model": 16})


@pytest.fixture
def mesh2x16x16():
    return FakeMesh({"pod": 2, "data": 16, "model": 16})
