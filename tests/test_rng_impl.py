"""The MCGP_RNG_IMPL=rbg bit source (ops/rng.engine_key).

rbg keeps the engine's draw-tree structure (fold_in stream derivation is
threefry over the key data either way) but routes bulk bit generation to the
XLA RngBitGenerator op instead of the software threefry rounds. Contract
under test: the repo's bitwise determinism + sharding-invariance guarantees
(test_determinism.py) must hold for rbg exactly as for the default
threefry; the two impls' values differ (documented in ops/rng.py) but must
agree distributionally.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from monte_carlo_gp.ops import rng
from monte_carlo_gp.ops.engine import run_monte_carlo


def test_default_impl_resolution(monkeypatch):
    """Default bit source: MCGP_RNG_IMPL wins; else threefry2x32."""
    monkeypatch.delenv("MCGP_RNG_IMPL", raising=False)
    assert rng.default_impl() == "threefry2x32"
    # Read at call time: a post-import env change takes effect immediately.
    monkeypatch.setenv("MCGP_RNG_IMPL", "rbg")
    assert rng.default_impl() == "rbg"


@pytest.mark.parametrize("env, impl", [
    (None, "threefry2x32"),
    ("", "threefry2x32"),
    ("threefry2x32", "threefry2x32"),
    ("rbg", "rbg"),
    ("unsafe_rbg", "unsafe_rbg"),
])
def test_default_impl_env_override(monkeypatch, env, impl):
    if env is None:
        monkeypatch.delenv("MCGP_RNG_IMPL", raising=False)
    else:
        monkeypatch.setenv("MCGP_RNG_IMPL", env)
    assert rng.default_impl() == impl


@pytest.mark.parametrize("backend", ["cpu", "gpu", "metal"])
def test_default_impl_ignores_the_platform(monkeypatch, backend):
    """The default is threefry2x32 whatever the backend: no platform branch."""
    monkeypatch.delenv("MCGP_RNG_IMPL", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert rng.default_impl() == "threefry2x32"


def test_engine_key_conversion():
    key = jax.random.PRNGKey(3)
    same = rng.engine_key(key)  # default impl: pass-through
    np.testing.assert_array_equal(np.asarray(same), np.asarray(key))
    rk = rng.engine_key(key, "rbg")
    assert jnp.issubdtype(rk.dtype, jax.dtypes.prng_key)
    # The stream-derivation chain must work unchanged on the converted key.
    u = jax.random.uniform(rng.lap_stream(rk, 5, rng.STREAM_DNF), (4, 8))
    assert u.shape == (4, 8) and bool(jnp.all((u >= 0) & (u < 1)))


def test_rbg_deterministic_and_distinct_from_threefry(std_setup):
    params, key = std_setup
    a = np.asarray(run_monte_carlo(params, key, 512, 20, rng_impl="rbg"))
    b = np.asarray(run_monte_carlo(params, key, 512, 20, rng_impl="rbg"))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(a.sum(axis=0), 1.0, rtol=1e-5)
    tf = np.asarray(run_monte_carlo(params, key, 512, 20))
    assert not np.array_equal(a, tf)  # different bit streams at the same seed


def test_rbg_matches_threefry_distributionally(std_setup):
    """Mean finish position per driver: SE ≈ sigma/sqrt(n) ≈ 0.09 at 4096
    sims with position-spread sigma ≲ 3 — a 0.5 gate catches any stream
    corruption (reused bits, broken fold_in) without being flaky."""
    params, key = std_setup
    n = 4096
    d = params.n_drivers
    pos = np.arange(1, d + 1, dtype=np.float64)
    mean_tf = np.asarray(run_monte_carlo(params, key, n, 20)) @ pos
    mean_rbg = np.asarray(run_monte_carlo(params, key, n, 20, rng_impl="rbg")) @ pos
    np.testing.assert_allclose(mean_rbg, mean_tf, atol=0.5)


def test_rbg_sharding_invariance(std_setup):
    """The headline bitwise contract holds under rbg: 1 device vs 8-way
    sims-sharded produce identical histograms (mirrors
    test_determinism.test_sharding_invariance)."""
    params, key = std_setup
    n = 1024

    single = np.asarray(run_monte_carlo(params, key, n, 20, rng_impl="rbg"))

    devices = np.array(jax.devices()[:8]).reshape(8)
    mesh = Mesh(devices, ("sims",))

    @jax.jit
    def sharded_run(params, key):
        from monte_carlo_gp.ops.engine import _histogram, simulate_races

        pos = simulate_races(params, key, n, 20, rng_impl="rbg")
        pos = jax.lax.with_sharding_constraint(
            pos, NamedSharding(mesh, P("sims", None))
        )
        return _histogram(pos, params.n_drivers).astype(jnp.float32) / n

    with jax.set_mesh(mesh):
        sharded = np.asarray(sharded_run(params, key))
    np.testing.assert_array_equal(single, sharded)
