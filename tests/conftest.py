"""Test configuration: run JAX on a virtual 8-device CPU mesh so the
sharding logic is testable without an accelerator (SURVEY.md section 4), and
enable the persistent compilation cache (compiles dominate the suite's time).

The CPU backend is forced through ``jax.config`` before any backend is
initialized; XLA_FLAGS must be set in the environment (it is read when the
XLA client is created).  A session-scoped assertion checks that the suite is
hermetic: 8 CPU devices.  Tests that need the GPU carry the ``gpu`` marker
and skip here; chip_smoke.py runs the same checks on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (must follow the env setup above)

from semantic_dsp_map_tpu.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_compile_cache(min_compile_secs=0.1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips on the CPU (chip_smoke.py runs it)"
    )


def pytest_sessionstart(session):
    devs = jax.devices()
    assert all(d.platform == "cpu" for d in devs), (
        "test suite must run on the CPU backend, got %r" % (devs,)
    )
    assert len(devs) == 8, (
        "expected the 8-virtual-device CPU platform, got %d devices" % len(devs)
    )
