"""Counter-based RNG stream derivation.

All stochastic draws in the engine come from a single base key, fanned out by
(lap, stream) with `fold_in`. Because `jax_threefry_partitionable` is enabled
(package __init__), full-shape draws like `normal(key, (S, D))` produce the
same global values under any device sharding — this is the bitwise
reproducibility contract from BASELINE.md.

The reference consumes one global Python/NumPy RNG stream in data-dependent
order (simulation.py passim), which is impossible (and pointless) to match
bitwise; the contract there is distributional equality at fixed seed.
"""

from __future__ import annotations

import os

import jax

# Bit-source implementation for the engine's bulk draws.
#   threefry2x32 (default) — pure-software counter-based bits; bitwise
#     stable across backends and JAX versions.
#   rbg — key derivation (fold_in/split) is still threefry over the key
#     data, but bulk bit *generation* lowers to the XLA RngBitGenerator op,
#     which skips the software threefry rounds. Sharding/device-count bitwise
#     invariance holds (tests/test_rng_impl.py); values are NOT stable across
#     backends or XLA versions, so rbg results differ from threefry results
#     at the same seed. Its speed on the H100 is not measured.
#
# MCGP_RNG_IMPL overrides the default, read at call time.


def default_impl() -> str:
    """The bit source: MCGP_RNG_IMPL if set, else threefry2x32 on every
    platform. Read at call time, not import time, so setting the env var
    after the package is imported still takes effect."""
    return os.environ.get("MCGP_RNG_IMPL") or "threefry2x32"


# Stream ids — one per independent random decision in the event model.
STREAM_GRID = 0          # grid sampling gumbels
STREAM_RACE_CONTROL = 1  # red-flag / SC / VSC uniforms
STREAM_VSC_REFUND = 2    # 30% tire-age refund draw under VSC
STREAM_DNF = 3           # per-car DNF Bernoulli
STREAM_LAP_NOISE = 4     # per-car lap-time gaussian
STREAM_START = 5         # lap-1 start-delta gaussian
STREAM_OVERTAKE = 6      # overtake success draws (subkeys per pass/phase)

_N_STREAMS = 16  # spacing between lap counters; > number of streams above


def lap_stream(key: jax.Array, lap, stream: int) -> jax.Array:
    """Derive the key for (lap, stream). `lap` may be a traced int."""
    return jax.random.fold_in(key, lap * _N_STREAMS + stream)


def subkey(key: jax.Array, i: int) -> jax.Array:
    """Derive the i-th subkey of a stream key (e.g. overtake pass/phase)."""
    return jax.random.fold_in(key, i)


def engine_key(key: jax.Array, impl: str | None = None) -> jax.Array:
    """Convert the engine's base key to the configured bit-source impl.

    `impl=None` resolves via `default_impl()` (MCGP_RNG_IMPL if set, else
    threefry2x32). For 'rbg' the (2,)-word threefry key
    data is doubled into the (4,)-word rbg layout; all stream structure
    still comes from `fold_in`, so the threefry and rbg draw trees are
    derived identically — only the bulk bit generation differs.
    """
    impl = impl or default_impl()
    if impl == "threefry2x32":
        return key
    import jax.numpy as jnp

    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        data = jax.random.key_data(key)
    else:
        data = key
    return jax.random.wrap_key_data(jnp.concatenate([data, data]), impl=impl)
