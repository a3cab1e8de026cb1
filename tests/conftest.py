"""Test configuration.

By default the tests run on a virtual 8-device CPU mesh, so the
multi-device sharding logic is exercised without hardware (SURVEY.md §4).
With ``QUPS_TEST_DEVICE=gpu`` the platform is left as JAX finds it and the
tests marked ``gpu`` (kernels compiled for the card) run; elsewhere they
skip. ``python chip_smoke.py`` runs them on the card.
"""
import os
import sys

import pytest

if os.environ.get("QUPS_TEST_DEVICE", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    if "jax" in sys.modules:  # imported before this file: set it directly
        sys.modules["jax"].config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: compiles a kernel for the card and compares it there; skips "
        "where the default JAX device is no GPU (chip_smoke.py runs them)")
    config.addinivalue_line(
        "markers",
        "full: exhaustive tier — deselected by default; run with "
        "QUPS_TEST_TIER=full (or -m full) like the reference's "
        "Github/full test tags (buildfile.m:57-76)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests without a card, decided per test (never
    at import, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    from qups_jax.utils.backend import on_gpu
    if not on_gpu():
        pytest.skip("needs a GPU: run on the card by chip_smoke.py")


def pytest_collection_modifyitems(config, items):
    """Two-tier suite: the default run deselects ``full``-marked tests
    (redundant parametrizations / exhaustive ablation rows — CI runs them
    in one nightly/opt-in job); an explicit ``-m`` or
    ``QUPS_TEST_TIER=full`` gets everything."""
    if config.option.markexpr:
        return
    if os.environ.get("QUPS_TEST_TIER", "fast") == "full":
        return
    keep, drop = [], []
    for it in items:
        (drop if it.get_closest_marker("full") else keep).append(it)
    if drop:
        config.hook.pytest_deselected(items=drop)
        items[:] = keep


import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
