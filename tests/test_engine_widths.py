"""The engine's structure at each edge of the rank-key packing tiers.

`ops/ranking.rank_by_unique` packs keys in three tiers (<= 32, 33..64,
65..128 rows) and falls back to the exact lexicographic rank above 128.
At every tier edge a short race must still give each simulation a
permutation of the finishing positions, a histogram whose rows and columns
each count every simulation once, and the same result for the same key.
"""

import functools

import jax
import numpy as np
import pytest

from monte_carlo_gp.config import make_sim_params
from monte_carlo_gp.ops.engine import _histogram, simulate_races

TIER_EDGES = [2, 32, 33, 64, 65, 128, 129]
N_SIMS = 64
LAPS = 4


def field(d: int):
    rng = np.random.default_rng(d)
    idx = np.arange(d)
    grid = np.exp(-((idx[None, :] - idx[:, None]) ** 2) / 6.0).astype(np.float32)
    grid /= grid.sum(axis=1, keepdims=True)
    return make_sim_params(
        grid_probs=grid,
        base_pace=90.0 + 0.05 * idx + 0.05 * rng.standard_normal(d),
        tire_deg=np.full(d, 0.05),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.02),
        team_dnf_rate=np.full(d, 0.002),
        pit_loss=21.0,
        overtake_delta=0.6,
    )


@functools.partial(jax.jit, static_argnums=(2, 3))
def _race(params, key, n_sims, laps):
    """(positions, counts): what `run_monte_carlo` computes for one block,
    in one compile (the lap step unrolls over the field, so each width
    costs a compile of its own)."""
    positions = simulate_races(params, key, n_sims, laps)
    return positions, _histogram(positions, params.n_drivers)


@pytest.mark.parametrize("d", TIER_EDGES)
def test_engine_structure_at_tier_edges(d):
    params = field(d)
    key = jax.random.PRNGKey(d)
    positions, counts = (np.asarray(a) for a in _race(params, key, N_SIMS, LAPS))
    assert positions.shape == (N_SIMS, d)
    np.testing.assert_array_equal(
        np.sort(positions, axis=1), np.broadcast_to(np.arange(1, d + 1), (N_SIMS, d))
    )
    # the histogram counts each (driver, position) pair of the positions
    expected = (positions[..., None] == np.arange(1, d + 1)).sum(axis=0)
    np.testing.assert_array_equal(counts, expected)
    np.testing.assert_array_equal(counts.sum(axis=0), N_SIMS)
    np.testing.assert_array_equal(counts.sum(axis=1), N_SIMS)
    again, _ = _race(params, key, N_SIMS, LAPS)
    np.testing.assert_array_equal(positions, np.asarray(again))
