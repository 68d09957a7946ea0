"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharding paths are
validated on a host-platform mesh exactly as the reference's CI validates
behavior without special hardware (3-OS matrix, rust.yml:28-30).

A marker-gated hardware leg runs on a machine with an NVIDIA GPU:

    COMPU_GPU_TESTS=1 python -m pytest tests/test_gpu_leg.py -m gpu -q

``chip_smoke.py`` runs the same leg inside its own process. With
``COMPU_GPU_TESTS=1`` the environment's platform is kept; otherwise JAX is
pinned to the CPU. Tests marked ``gpu`` take the ``gpu_device`` fixture,
which skips them when no GPU is present.
"""

import os

import pytest

GPU_LEG = os.environ.get("COMPU_GPU_TESTS", "") == "1"

if not GPU_LEG:
    # Force CPU regardless of the environment's default platform.
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    try:
        import jax

        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("hardware leg: no GPU present")
    return devs[0]
