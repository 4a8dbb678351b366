"""Monte Carlo driver: grid sampling -> lap-1 -> lap scan -> classification
-> finish-position histogram.

This is the batched replacement for the reference's serial loop
`RaceSimulator.run_monte_carlo` (reference simulation.py:59-100): instead of
10,000 sequential Python race simulations, all simulations advance together
through a single `lax.scan` over laps, carrying a (n_sims, D) struct-of-arrays
state. Simulations are processed in fixed-size blocks (an outer `lax.map`)
to bound peak device memory for very large n_sims; within a block, the
simulation axis is the sharding axis for multi-device scale-out.

Reproducibility: all draws are counter-based threefry keyed by
(seed, block, lap, stream); with `jax_threefry_partitionable` results are
bitwise identical per (seed, n_sims, block size) under any device sharding.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from monte_carlo_gp.config import SimParams
from monte_carlo_gp.ops import rng
from monte_carlo_gp.ops.grid_sampling import sample_grid
from monte_carlo_gp.ops.lap_engine import (
    FUEL_PER_LAP,
    FUEL_START,
    classify,
    init_cars,
    lap_step,
    simulate_lap_1,
)

# Sims per block: a memory bound. At 20 drivers the 1,048,576-sim program
# in 65,536-sim blocks needs 51.6 MB of device temporaries
# (`memory_analysis`, NVIDIA H100 80GB HBM3 at a 400 W limit; chip_smoke.py
# prints it). Its speed against other block sizes is not measured on the
# H100 (benchmarks/xla_block_sweep.py sweeps it).
DEFAULT_BLOCK = 65_536

# Every carried (n_sims, D) array is written and re-read through device
# memory once per lap. The six integer state fields all fit int8 under the
# _NARROW_MAX_LAPS=120 guard (the largest value is tire_age <= total_laps +
# 4 = 124), so the carry is narrowed at the scan boundary — lap_step itself
# stays int32 — cutting carried bytes/car from 38 to 17 (2 f32 + 6 int8 +
# 2 bool + int8 rank; fuel is derived in the decode). The casts fuse into
# the adjacent loop kernels. Skipped for pathological total_laps where int8
# could wrap. What the narrowing saves on the H100 is not measured.
_NARROW_FIELDS = ("tire_age", "compound", "used_mask", "pit_stops", "laps_done", "dnf_lap")
_NARROW_MAX_LAPS = 120


def _encode_carry(cars, narrow: bool):
    """Narrow the carried ints to int8 and drop fuel (17 bytes/car vs 38
    unpacked). fuel is in lockstep with laps_done (both gated on the same
    `alive` every lap; lap 1 burns fuel without counting as a completed
    lap), and every reachable value is a multiple of 0.5 <= 110, so the
    decode reconstructs it bitwise identically. Denser bit-packing (DRS in
    the tire_age sign, used_mask folded into compound, dnf via a dnf_lap
    sentinel, 13 bytes/car) saves 4 more bytes for extra codec ops per
    lap; it is not used."""
    if not narrow:
        return cars
    return dataclasses.replace(
        cars,
        fuel=jnp.zeros((), jnp.float32),
        **{f: getattr(cars, f).astype(jnp.int8) for f in _NARROW_FIELDS},
    )


def _decode_carry(cars, narrow: bool):
    if not narrow:
        return cars
    laps_done = cars.laps_done.astype(jnp.int32)
    dnf_lap = cars.dnf_lap.astype(jnp.int32)
    took_lap_1 = ~(cars.dnf & (dnf_lap < 2))  # lap-1 DNFs / padding burn none
    fuel = jnp.maximum(
        0.0,
        FUEL_START - FUEL_PER_LAP * (laps_done + took_lap_1).astype(jnp.float32),
    )
    return dataclasses.replace(
        cars,
        fuel=fuel,
        laps_done=laps_done,
        dnf_lap=dnf_lap,
        **{
            f: getattr(cars, f).astype(jnp.int32)
            for f in _NARROW_FIELDS
            if f not in ("laps_done", "dnf_lap")
        },
    )


def simulate_races_state(
    params: SimParams,
    key: jax.Array,
    n_sims: int,
    total_laps: int,
    race_laps: jax.Array | None = None,
    rng_impl: str | None = None,
):
    """Simulate `n_sims` races; return ((n_sims, D) 1-indexed finish
    positions, final `Cars` state). The state return is for tests/debugging.

    One grid sample + race per simulation (reference simulation.py:83-94).

    `race_laps` (optional traced int32 scalar <= total_laps) enables a single
    compile to serve circuits with different lap counts: the lap loop becomes
    a while_loop that executes exactly `race_laps` iterations inside the
    `total_laps` compile bucket. Used by the multi-race season path
    (parallel/sharded.py lax.map) where lap counts vary across the batched
    races (SURVEY.md §7 "variable laps" hard part).

    `rng_impl` selects the bulk bit source (None -> MCGP_RNG_IMPL if set,
    else threefry2x32; see ops/rng.default_impl).
    The draw-tree structure is impl-independent.
    """
    key = rng.engine_key(key, rng_impl)
    start_pos = sample_grid(
        jax.random.fold_in(key, rng.STREAM_GRID),
        params.grid_probs,
        n_sims,
        params.active,
    )
    cars = init_cars(params, start_pos)
    # Padding slots beyond the real entry list are retired before the start
    # so they classify last and never interact with live cars.
    cars = dataclasses.replace(cars, dnf=cars.dnf | ~params.active[None, :])
    cars, rank0 = simulate_lap_1(params, cars, start_pos, key)

    drs_until0 = jnp.zeros((n_sims,), jnp.int32)
    laps_total = race_laps if race_laps is not None else jnp.int32(total_laps)
    narrow = total_laps <= _NARROW_MAX_LAPS

    narrow_rank = params.n_drivers <= 127  # rank values < D must fit int8

    def do_lap(enc_cars, drs_until, enc_rank, lap):
        cars = _decode_carry(enc_cars, narrow)
        rank = enc_rank.astype(jnp.int32) if narrow_rank else enc_rank
        new_cars, new_drs, new_rank = lap_step(
            params, laps_total, cars, drs_until, lap, key, prev_rank=rank
        )
        new_enc = _encode_carry(new_cars, narrow)
        if narrow_rank:
            new_rank = new_rank.astype(jnp.int8)
        return new_enc, new_drs, new_rank

    rank0_enc = rank0.astype(jnp.int8) if narrow_rank else rank0
    carry0 = (_encode_carry(cars, narrow), drs_until0, rank0_enc)
    if race_laps is None:
        laps = jnp.arange(2, total_laps + 1, dtype=jnp.int32)
        (enc_cars, _, _), _ = jax.lax.scan(
            lambda c, lap: (do_lap(*c, lap), None), carry0, laps
        )
    else:
        # Dynamic trip count: run exactly `race_laps` laps instead of
        # scanning the whole padded bucket with masked no-op tails — a
        # 57-lap race in a 78-lap compile bucket costs 57 laps, not 78. The body
        # is the identical lap step, so results stay bitwise equal to the
        # full-length scan (tests/test_sharding.py masked-laps test).
        bound = jnp.minimum(laps_total, jnp.int32(total_laps))

        def w_cond(state):
            return state[0] <= bound

        def w_body(state):
            lap, c = state
            return lap + 1, do_lap(*c, lap)

        _, (enc_cars, _, _) = jax.lax.while_loop(
            w_cond, w_body, (jnp.int32(2), carry0)
        )
    cars = _decode_carry(enc_cars, narrow)
    return classify(cars), cars


def simulate_races(
    params: SimParams,
    key: jax.Array,
    n_sims: int,
    total_laps: int,
    race_laps: jax.Array | None = None,
    rng_impl: str | None = None,
) -> jax.Array:
    """Simulate `n_sims` races; return (n_sims, D) 1-indexed finish positions."""
    return simulate_races_state(params, key, n_sims, total_laps, race_laps, rng_impl)[0]


def _histogram(positions: jax.Array, d: int) -> jax.Array:
    """(S, D) 1-indexed positions -> (D, D) int32 counts[driver, position-1]."""
    onehot = positions[..., None] == jnp.arange(1, d + 1, dtype=positions.dtype)
    return jnp.sum(onehot, axis=0, dtype=jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("n_sims", "total_laps", "sims_per_block", "rng_impl")
)
def run_monte_carlo(
    params: SimParams,
    key: jax.Array,
    n_sims: int,
    total_laps: int,
    sims_per_block: int | None = None,
    race_laps: jax.Array | None = None,
    rng_impl: str | None = None,
) -> jax.Array:
    """Run `n_sims` simulations, return (D, D) float32 probabilities:
    probs[driver, p] = P(driver finishes in position p+1).

    This is the whole-subtree replacement for the reference hot loop
    (SURVEY.md §3.1). `sims_per_block` bounds peak memory: blocks run
    sequentially via `lax.map`, each fully batched and sharded.

    `race_laps` (traced int32 scalar <= total_laps) lets ONE compile at a
    padded `total_laps` bucket serve every circuit: the lap loop executes
    exactly `race_laps` iterations (dynamic while_loop trip count), so the
    padding costs nothing. The predictor buckets lap counts to multiples of
    16 so a season backtest compiles ~5 programs instead of ~15.
    """
    d = params.n_drivers
    if sims_per_block is None or sims_per_block >= n_sims:
        positions = simulate_races(params, key, n_sims, total_laps, race_laps, rng_impl)
        counts = _histogram(positions, d)
        return counts.astype(jnp.float32) / n_sims

    if n_sims % sims_per_block != 0:
        raise ValueError(
            f"n_sims={n_sims} must be a multiple of sims_per_block={sims_per_block}"
        )
    n_blocks = n_sims // sims_per_block

    def block(block_idx):
        bkey = jax.random.fold_in(key, block_idx)
        positions = simulate_races(
            params, bkey, sims_per_block, total_laps, race_laps, rng_impl
        )
        return _histogram(positions, d)

    counts = jax.lax.map(block, jnp.arange(n_blocks, dtype=jnp.int32))
    return jnp.sum(counts, axis=0).astype(jnp.float32) / n_sims
