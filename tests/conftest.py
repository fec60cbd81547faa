"""Test environment: CPU backend with 8 virtual devices.

SURVEY.md §4.4: multi-host code paths are tested without a cluster via
XLA's forced host platform device count; all Mesh/shard_map/psum code runs
unmodified.  Must be set before jax initialises its backends, hence here.
"""

import os

# Force the CPU backend, also on a machine with a GPU: the suite's
# tolerances and device counts are those of XLA:CPU with 8 virtual
# devices.  Checks that need the card are marked `gpu`, skip here, and run
# on the card in chip_smoke.py.  XLA_FLAGS must be set before the first
# backend init for the 8 virtual devices to appear.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# SURVEY.md §5.2 sanitizer promise: fail the suite on any NaN produced by
# a jitted op.  All masked-lane math in the package is structured to keep
# dead lanes finite (zeros / -inf, never 0/0), so this is a real invariant,
# not a tolerated-noise check.
jax.config.update("jax_debug_nans", True)
assert jax.default_backend() == "cpu", jax.default_backend()
assert jax.device_count() == 8, jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long soak tests (minutes on CPU); run by default, "
        "deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (use the `gpu` fixture, which skips "
        "without one); chip_smoke.py runs these checks on the card")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none.

    Decided here, at run time, never at import: every xdist worker must
    collect the same tests.
    """
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    One pytest process accumulates every module's XLA:CPU JIT code as
    live mmap regions (~55 new maps/s measured); past ~140 tests the
    process segfaults inside backend_compile (map-table exhaustion, two
    reproductions 2026-08-17 both in the test_slam region).  Eviction
    costs only cross-module compile reuse, which is near zero — modules
    compile distinct configs.
    """
    yield
    import gc
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def rng():
    """A fresh seeded generator per test: a test's data must not depend on
    which tests an xdist worker happened to run before it."""
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def test_image():
    from cusift_tpu.data.synthetic import textured_image
    return textured_image(240, 320, seed=1)


@pytest.fixture(scope="session")
def test_image_large():
    from cusift_tpu.data.synthetic import textured_image
    return textured_image(480, 640, seed=2)
