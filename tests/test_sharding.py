"""Multi-chip scale-out on the virtual 8-device CPU mesh: sharded runs must
be bitwise identical to single-device runs; season batches must match
per-race runs; variable lap counts must be exact under masking."""

import jax
import numpy as np
import pytest

from monte_carlo_gp.ops.engine import run_monte_carlo, simulate_races
from monte_carlo_gp.parallel.mesh import make_mesh, sharded_monte_carlo
from monte_carlo_gp.parallel.sharded import simulate_season_sharded, stack_params


def test_make_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape == {"sims": 8}
    mesh2 = make_mesh({"race": 2, "sims": 4})
    assert mesh2.shape == {"race": 2, "sims": 4}
    with pytest.raises(ValueError):
        make_mesh({"sims": 99})


def test_sharded_matches_single_device(std_setup):
    params, key = std_setup
    single = np.asarray(run_monte_carlo(params, key, 1024, 15))
    sharded = np.asarray(
        sharded_monte_carlo(params, key, 1024, 15, mesh=make_mesh({"sims": 8}))
    )
    np.testing.assert_array_equal(single, sharded)


def test_sharded_rejects_uneven_split(std_setup):
    params, key = std_setup
    with pytest.raises(ValueError):
        sharded_monte_carlo(params, key, 1001, 15)


def test_masked_race_laps_exact(std_setup):
    """A race run with race_laps=L inside a longer max-lap scan must equal
    the plain L-lap run bit for bit."""
    params, key = std_setup
    import jax.numpy as jnp

    plain = np.asarray(simulate_races(params, key, 256, 12))
    masked = np.asarray(
        simulate_races(params, key, 256, 20, race_laps=jnp.int32(12))
    )
    np.testing.assert_array_equal(plain, masked)


def test_season_sharded_matches_per_race(std_setup):
    params, key = std_setup
    laps = [12, 17]
    probs = simulate_season_sharded(
        [params, params], laps, key, n_sims=512,
        mesh=make_mesh({"race": 2, "sims": 4}),
    )
    assert probs.shape == (2, 20, 20)
    for r, lap_count in enumerate(laps):
        rkey = jax.random.fold_in(key, r)
        solo = np.asarray(run_monte_carlo(params, rkey, 512, lap_count))
        np.testing.assert_array_equal(probs[r], solo)


def test_stack_params_pads_drivers(std_setup):
    import dataclasses

    import jax.numpy as jnp

    params, key = std_setup
    small = dataclasses.replace(
        params,
        grid_probs=params.grid_probs[:16, :16],
        base_pace=params.base_pace[:16],
        tire_deg=params.tire_deg[:16],
        variance=params.variance[:16],
        dnf_rate=params.dnf_rate[:16],
        team_dnf_rate=params.team_dnf_rate[:16],
        active=params.active[:16],
    )
    stacked, d = stack_params([params, small])
    assert d == 20
    assert stacked.base_pace.shape == (2, 20)
    assert not bool(stacked.active[1, 16])
    # padded race still simulates: real drivers get positions 1..16
    probs = simulate_season_sharded(
        [params, small], [10, 10], key, n_sims=256,
        mesh=make_mesh({"race": 2, "sims": 4}),
    )
    # padded drivers always classify last (positions 17-20)
    np.testing.assert_allclose(probs[1, 16:, 16:].sum(axis=-1), 1.0, atol=1e-5)
    assert probs[1, :16, 16:].sum() == 0.0
