"""Reproducibility contract (BASELINE.md): bitwise-identical results per
seed, invariant to device sharding and to jit/eager boundaries."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from monte_carlo_gp.ops.engine import run_monte_carlo


def test_same_seed_same_result(std_setup):
    params, key = std_setup
    a = np.asarray(run_monte_carlo(params, key, 512, 20))
    b = np.asarray(run_monte_carlo(params, key, 512, 20))
    np.testing.assert_array_equal(a, b)


def test_different_seed_different_result(std_setup):
    params, key = std_setup
    a = np.asarray(run_monte_carlo(params, key, 512, 20))
    b = np.asarray(run_monte_carlo(params, jax.random.PRNGKey(99), 512, 20))
    assert not np.array_equal(a, b)


def test_carry_codec_is_bitwise_transparent(std_setup, monkeypatch):
    """The int8 scan-carry codec (engine._encode_carry/_decode_carry, plus
    the derived fuel) must be a pure traffic optimization: disabling it via
    the _NARROW_MAX_LAPS guard must reproduce the narrowed path's finish
    probabilities BIT FOR BIT. Also exercises the narrow=False branch,
    which no real race reaches (all circuits are <= 120 laps)."""
    from monte_carlo_gp.ops import engine as eng

    params, key = std_setup
    narrowed = np.asarray(run_monte_carlo(params, key, 512, 24))
    monkeypatch.setattr(eng, "_NARROW_MAX_LAPS", 0)
    eng.run_monte_carlo.clear_cache()
    try:
        wide = np.asarray(run_monte_carlo(params, key, 512, 24))
    finally:
        eng.run_monte_carlo.clear_cache()
    np.testing.assert_array_equal(narrowed, wide)


def test_block_splitting_changes_nothing_about_validity(std_setup):
    """Blocked and unblocked runs use different key fan-out, so they are
    different (documented) — but both are valid distributions and each is
    itself deterministic."""
    params, key = std_setup
    blocked = np.asarray(
        run_monte_carlo(params, key, 512, 20, sims_per_block=128)
    )
    blocked2 = np.asarray(
        run_monte_carlo(params, key, 512, 20, sims_per_block=128)
    )
    np.testing.assert_array_equal(blocked, blocked2)
    np.testing.assert_allclose(blocked.sum(axis=1), 1.0, rtol=1e-5)


def test_sharding_invariance(std_setup):
    """The headline contract: the same seed produces bitwise-identical
    histograms whether the simulation batch lives on 1 device or is sharded
    across 8 (partitionable threefry + GSPMD)."""
    params, key = std_setup
    n = 1024

    single = np.asarray(run_monte_carlo(params, key, n, 20))

    devices = np.array(jax.devices()[:8]).reshape(8)
    mesh = Mesh(devices, ("sims",))
    # Shard every (S, D) intermediate over sims by sharding the key-derived
    # computation: jit with output sharding constraint on the batch axis.
    @jax.jit
    def sharded_run(params, key):
        from monte_carlo_gp.ops.engine import simulate_races

        pos = simulate_races(params, key, n, 20)
        pos = jax.lax.with_sharding_constraint(
            pos, NamedSharding(mesh, P("sims", None))
        )
        onehot = pos[..., None] == jnp.arange(1, params.n_drivers + 1)
        return jnp.sum(onehot, axis=0, dtype=jnp.int32).astype(jnp.float32) / n

    with jax.set_mesh(mesh):
        sharded = np.asarray(sharded_run(params, key))
    np.testing.assert_array_equal(single, sharded)
