"""Property tests: random valid parameter sets must always produce finite,
doubly-stochastic finish histograms — no NaNs, no lost probability mass —
across track conditions, event rates, grid shapes and field sizes."""

import jax
import numpy as np
import pytest

from monte_carlo_gp.config import make_sim_params
from monte_carlo_gp.ops.engine import run_monte_carlo


def random_params(rng: np.random.Generator):
    d = int(rng.choice([6, 10, 20]))
    grid_kind = rng.choice(["onehot", "gaussian", "uniform", "sparse"])
    if grid_kind == "onehot":
        gp = np.zeros((d, d), np.float32)
        gp[np.arange(d), rng.permutation(d)] = 1.0
    elif grid_kind == "gaussian":
        gp = np.exp(
            -((np.arange(d)[None, :] - rng.permutation(d)[:, None]) ** 2)
            / rng.uniform(1, 20)
        ).astype(np.float32)
        gp /= gp.sum(1, keepdims=True)
    elif grid_kind == "uniform":
        gp = np.full((d, d), 1.0 / d, np.float32)
    else:  # sparse: some drivers have all-zero columns (fallback path)
        gp = (rng.random((d, d)) * (rng.random((d, d)) > 0.7)).astype(np.float32)
    return make_sim_params(
        grid_probs=gp,
        base_pace=rng.uniform(70, 110, d).astype(np.float32),
        tire_deg=rng.uniform(0.0, 0.2, d).astype(np.float32),
        variance=rng.uniform(0.0, 0.5, d).astype(np.float32),
        dnf_rate=rng.uniform(0.0, 0.05, d).astype(np.float32),
        team_dnf_rate=rng.uniform(0.0, 0.05, d).astype(np.float32),
        pit_loss=float(rng.uniform(15, 35)),
        overtake_delta=float(rng.uniform(0.2, 2.0)),
        sc_prob=float(rng.uniform(0, 0.2)),
        vsc_prob=float(rng.uniform(0, 0.2)),
        red_flag_prob=float(rng.uniform(0, 0.05)),
        track_condition=str(rng.choice(["dry", "damp", "wet"])),
    ), d


@pytest.mark.slow
@pytest.mark.parametrize("case", range(8))
def test_random_params_produce_valid_histograms(case):
    rng = np.random.default_rng(1000 + case)
    params, d = random_params(rng)
    laps = int(rng.integers(5, 30))
    probs = np.asarray(
        run_monte_carlo(params, jax.random.PRNGKey(case), 512, laps)
    )
    assert np.isfinite(probs).all(), (case, probs)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs.sum(axis=0), 1.0, atol=1e-5)
    assert (probs >= 0).all()


@pytest.mark.slow
def test_extreme_rates_every_lap_event():
    """All event probabilities at 1.0: a red flag fires every lap (priority
    chain) — still a valid race."""
    rng = np.random.default_rng(99)
    params, d = random_params(rng)
    import dataclasses

    import jax.numpy as jnp

    one = jnp.ones(())
    params = dataclasses.replace(
        params, sc_prob=one, vsc_prob=one, red_flag_prob=one
    )
    probs = np.asarray(run_monte_carlo(params, jax.random.PRNGKey(0), 256, 15))
    assert np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.slow
def test_single_driver_field():
    params = make_sim_params(
        grid_probs=np.ones((1, 1), np.float32),
        base_pace=np.array([90.0], np.float32),
        tire_deg=np.array([0.05], np.float32),
        variance=np.array([0.15], np.float32),
        dnf_rate=np.array([0.01], np.float32),
        team_dnf_rate=np.array([0.01], np.float32),
    )
    probs = np.asarray(run_monte_carlo(params, jax.random.PRNGKey(0), 128, 10))
    assert probs.shape == (1, 1) and probs[0, 0] == 1.0
