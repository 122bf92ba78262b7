"""Test configuration: force an 8-virtual-device CPU platform so sharding /
multi-device paths are exercised without an accelerator, and enable x64 so
parity tests can match the reference's numpy-float64 arithmetic bit-for-bit.

Tests that need the GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them here; they run on a card with
``python -m pytest -m gpu`` under ``JAX_PLATFORMS=cuda``."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# jax.config forces the CPU platform before first use, unless the GPU-only
# tests were asked for with JAX_PLATFORMS=cuda
if os.environ.get("JAX_PLATFORMS", "cpu") != "cuda":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib  # noqa: E402
import sys  # noqa: E402

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import pytest  # noqa: E402

REFERENCE_ROOT = pathlib.Path("/root/reference")

CHOPIN_REF = REFERENCE_ROOT / "Songs/chopin/chopin_rubinstein_20b.wav"
CHOPIN_LIVE = REFERENCE_ROOT / "Songs/chopin/chopin_rachmaninoff_20b.wav"


@pytest.fixture(scope="session")
def chopin_pair():
    """The only audio pair present in the reference mount (SURVEY.md §2 C16)."""
    if not (CHOPIN_REF.exists() and CHOPIN_LIVE.exists()):
        pytest.skip("reference Chopin 20-bar wavs not available")
    return str(CHOPIN_REF), str(CHOPIN_LIVE)


@pytest.fixture
def gpu_device():
    """The GPU, for tests marked ``gpu``; decided here at run time, never
    at import, so every worker collects the same tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (running on {devices[0].platform})")
    return devices[0]


@pytest.fixture
def reference_root():
    """The reference project's checkout (corpus audio, beat CSVs, recorded
    field logs); tests that read it skip when it is not mounted."""
    if not REFERENCE_ROOT.exists():
        pytest.skip("reference project checkout not mounted")
    return REFERENCE_ROOT
