"""Test harness configuration.

Puts JAX on a virtual 8-device CPU platform BEFORE jax initializes, so every
multi-device sharding path is exercised without accelerator hardware
(SURVEY.md §4). Must run before any jax import in the test session.

Tests marked `gpu` need an NVIDIA GPU and skip elsewhere; whether a GPU is
present is decided in a fixture at run time, never at import. Run them on
the card with MCGP_TEST_GPU=1, which leaves JAX's platform choice alone:

    MCGP_TEST_GPU=1 python -m pytest tests/ -m gpu

(chip_smoke.py runs exactly this as its phase 0).
"""

import os

_USE_GPU = os.environ.get("MCGP_TEST_GPU") == "1"

if not _USE_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))  # for tests.oracle imports

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def std_setup():
    """A 20-driver parameter set shared by engine tests."""
    import jax
    from monte_carlo_gp.config import make_sim_params

    d = 20
    rng = np.random.default_rng(7)
    grid_probs = np.zeros((d, d), np.float32)
    for i in range(d):
        for p in range(d):
            grid_probs[i, p] = np.exp(-((p - i) ** 2) / 8.0)
    grid_probs /= grid_probs.sum(axis=1, keepdims=True)
    params = make_sim_params(
        grid_probs=grid_probs,
        base_pace=90.0 + 0.06 * np.arange(d),
        tire_deg=np.clip(0.05 + 0.015 * rng.standard_normal(d), 0.01, 0.15),
        variance=np.full(d, 0.15, np.float32),
        dnf_rate=np.full(d, 0.0008, np.float32),
        team_dnf_rate=np.full(d, 0.002, np.float32),
        pit_loss=21.0,
        overtake_delta=0.6,
    )
    return params, jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a `gpu`-marked test unless JAX's default device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: MCGP_TEST_GPU=1 python -m pytest tests/ -m gpu"
        )
