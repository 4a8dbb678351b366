"""Lap-count compile bucketing (kills per-circuit recompiles).

The predictor compiles the engine at lap-count buckets (multiples of 16)
and passes the circuit's actual length as the traced `race_laps` scalar,
the lap loop's dynamic trip count, so padded laps never execute. Draws are
keyed by (key, lap, stream) — ops/rng.py — so a bucketed run is bitwise
equal to the exact-length compile.
"""

import jax
import jax.numpy as jnp
import numpy as np

from monte_carlo_gp.config import make_sim_params
from monte_carlo_gp.models.predictor import _lap_bucket
from monte_carlo_gp.ops.engine import run_monte_carlo


def params(d=8):
    gp = np.exp(
        -((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 6.0
    ).astype(np.float32)
    gp /= gp.sum(1, keepdims=True)
    return make_sim_params(
        grid_probs=gp,
        base_pace=90 + 0.12 * np.arange(d),
        tire_deg=np.full(d, 0.05),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.001),
        team_dnf_rate=np.full(d, 0.002),
        pit_loss=21.0,
        overtake_delta=0.6,
    )


def test_lap_bucket_math():
    assert _lap_bucket(44) == 48
    assert _lap_bucket(57) == 64
    assert _lap_bucket(64) == 64
    assert _lap_bucket(78) == 80
    assert _lap_bucket(5) == 16
    # the 2025 calendar's 22 distinct lap counts fall into 5 buckets
    from monte_carlo_gp.config import CIRCUITS

    buckets = {_lap_bucket(int(c["laps"])) for c in CIRCUITS.values()}
    assert len(buckets) <= 5, buckets


def test_xla_bucketed_run_is_bitwise_exact():
    """run_monte_carlo at a padded bucket with race_laps masking must equal
    the exact-length compile bit for bit (per-lap keyed draws)."""
    p = params()
    key = jax.random.PRNGKey(11)
    exact = np.asarray(run_monte_carlo(p, key, 2048, 25))
    bucketed = np.asarray(
        run_monte_carlo(p, key, 2048, 32, race_laps=jnp.int32(25))
    )
    np.testing.assert_array_equal(exact, bucketed)


def test_simulate_plan_buckets_and_stays_valid(tmp_path):
    """End-to-end: Bahrain (57 laps -> bucket 64) through simulate_plan
    produces valid, deterministic histograms."""
    from monte_carlo_gp.data.synthetic import SyntheticBackend
    from monte_carlo_gp.models.predictor import F1Predictor

    p = F1Predictor(cache_dir=tmp_path, backend=SyntheticBackend(seed=5, n_events=1))
    plan = p.prepare_weekend(2024, "Bahrain")
    assert plan.total_laps == 57
    a = p.simulate_plan(plan, 512, seed=3)
    b = p.simulate_plan(plan, 512, seed=3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a.sum(axis=1), 1.0, atol=1e-4)
