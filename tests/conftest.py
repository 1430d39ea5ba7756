"""Test configuration.

Runs the suite on the CPU with 8 virtual XLA devices so multi-device
sharding paths can be exercised without several accelerators (SURVEY.md
§4: the JAX counterpart of the reference's Debug backend trick). Tests
marked ``gpu`` need a GPU and skip elsewhere; run them on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a GPU; skipped elsewhere")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_gpu(request):
    """Decided here, at run time, never while a module is imported."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX's default device is "
                    f"{jax.devices()[0].platform})")


@pytest.fixture(autouse=True)
def _guard_x64_config():
    """Fail loudly if a test leaks a flipped jax_enable_x64 flag.

    The whole suite assumes f64 (FD gradient checks, exactness asserts,
    f64-only index paths). A process-global x64 flip leaking from one test
    silently poisons every later test file. This guard turns any future
    leak into ONE clear failure at the offending test instead of a hundred
    confusing ones downstream.
    """
    yield
    if not jax.config.jax_enable_x64:
        # Restore before failing so only the leaking test fails.
        jax.config.update("jax_enable_x64", True)
        pytest.fail(
            "test leaked jax_enable_x64=False into the process-global JAX "
            "config; snapshot/restore the flag inside the test"
        )
