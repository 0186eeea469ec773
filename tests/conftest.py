"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set XLA flags before jax initializes (SURVEY.md section 4: multi-device
paths are validated on --xla_force_host_platform_device_count simulation).

Tests that need the GPU carry the `gpu` marker and take the `gpu` fixture,
which skips them unless the suite runs on a GPU:

    PEM_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu

With PEM_TESTS_ON_GPU set the CPU is not forced and no virtual mesh is
made; every other test expects the 8-device CPU mesh.
"""

import os

ON_GPU = bool(os.environ.get("PEM_TESTS_ON_GPU"))

if not ON_GPU:
    # NOTE: pytest's plugin machinery may import jax BEFORE this conftest
    # runs, and jax snapshots JAX_PLATFORMS at import — so the env var
    # alone can be too late; the config update below is what takes effect
    # (it works as long as no backend has been initialized yet).
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", (
        "tests must run on the virtual CPU mesh, got "
        + jax.default_backend())
    assert len(jax.devices()) == 8, jax.devices()

import numpy as np
import pytest
import scipy.sparse as sp


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Bound in-process XLA:CPU JIT state.

    With the full suite in one process, the accumulated compiled-program
    state eventually segfaults XLA:CPU inside a later pjit compile
    (reproduced twice in round 3, always at whichever heavy compile runs
    ~70 programs in; any prefix subset passes).  Dropping executable
    caches between modules keeps the process under the threshold; the
    cost is only cross-module recompiles, which are mostly disjoint
    anyway.
    """
    yield
    import jax
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (run with PEM_TESTS_ON_GPU=1 on the "
        "card; skipped on the CPU)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided when the test
    runs, never at import, so every worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def random_sparse(n_rows, n_cols, density, seed=0, dtype=np.float64):
    """Random sparse matrix with exact-ish density, canonical COO."""
    rs = np.random.default_rng(seed)
    nnz = max(1, int(n_rows * n_cols * density))
    rows = rs.integers(0, n_rows, nnz)
    cols = rs.integers(0, n_cols, nnz)
    vals = rs.standard_normal(nnz).astype(dtype)
    m = sp.coo_matrix((vals, (rows, cols)), shape=(n_rows, n_cols))
    m.sum_duplicates()
    return m
