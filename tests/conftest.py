"""Test environment: force the CPU backend with 8 virtual devices so the
multi-device sharding paths run without accelerator hardware (SURVEY.md
§4: simulated mesh via xla_force_host_platform_device_count).  Tests that
need a GPU carry the `gpu` marker and run it in a subprocess.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


# --- fast/slow split -------------------------------------------------------
# Tests above ~7 s carry the `slow` marker via this central list, so
# `pytest -m "not slow"` (<5 min) still covers all core semantics.
_SLOW_TESTS = {
    "test_multihost.py::test_two_process_distributed_join",
    "test_pipeline.py::test_filter_join_aggregate_pipeline",
    "test_direct_large.py::test_fuzz_small_shapes",
    "test_merge_join.py::test_merge_validity_padding",
    "test_merge_join.py::test_merge_count[50-5000]",
}


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        rel = item.nodeid.split("/")[-1]
        if rel in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
