"""The per-lap race engine: state pytree, lap-1, the lap step, classification.

This reimplements the behavioral contract of the reference's
`RaceSimulator.simulate_race` (reference simulation.py:147-560) as pure,
batched array transformations:

  * car state is a struct-of-arrays pytree of shape (n_sims, D),
  * every `if`/`for` in the reference becomes a masked `where`,
  * every `sorted()` becomes a rank computation (ops/ranking.py),
  * every `random.random()` becomes a batched threefry draw (ops/rng.py).

Event order per lap (matching simulation.py:164-228): race-control draws
(red flag -> SC -> VSC priority chain) -> dirty-air precompute -> per-car
{DNF draw, lap time, bookkeeping} -> pit stops -> overtake passes ->
position/DRS update.

Known, intentional divergences from the serial reference (all measure-zero
or distribution-preserving; see tests/test_engine_stats.py):
  * tie-breaking in sorts uses the driver index instead of Python list order
    (ties between continuous lap times have probability zero),
  * the RNG stream structure differs (counter-based vs one global stream),
    so equality with the NumPy reference is distributional, not bitwise,
  * the reference's `set.pop()` on a 2-element compound set (simulation.py
    :481-485) is replaced by a deterministic choice (HARD for long stints,
    MEDIUM otherwise). NOT measure-zero: the popped element depends on
    CPython's per-process hash randomization, so at a fixed RNG seed the
    reference's distributions vary across processes (finish-TV up to 0.62
    between hash seeds at 20 drivers x 57 laps). Our fixed choice is one
    valid refinement, equal to the reference under hash seeds where pop()
    yields HARD/MEDIUM — see PARITY.md divergence #1 and
    tests/test_reference_ab.py.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp

from monte_carlo_gp import config as cfg
from monte_carlo_gp.config import SimParams
from monte_carlo_gp.ops import rng
from monte_carlo_gp.ops.ranking import (
    gather_at_rank,
    rank_by,
    rank_by_unique,
    scatter_by_rank,
    value_of_car_ahead,
)

INF_TIME = np.float32(1e30)  # numpy, not jnp: module-level jnp ops eagerly initialize the backend
FUEL_START = 110.0
FUEL_PER_LAP = 1.5
FUEL_PACE_GAIN = 0.03  # seconds per kg burned (simulation.py:327)
LAP_1_DNF_MULTIPLIER = 4.0  # simulation.py:282
SC_GAP = 0.5  # bunched gap per position under SC (simulation.py:360)
SC_LAPPED_SPACING = 90.0  # per-lap-down spacing estimate (simulation.py:367)
VSC_GAP_FACTOR = 0.8  # simulation.py:390
VSC_REFUND_PROB = 0.3  # simulation.py:393
RED_FLAG_GAP = 0.1  # standing-start interval (simulation.py:414)
OVERTAKE_PASSES = 3  # simulation.py:503
OVERTAKE_RESET_GAP = 0.3  # gap after a pass (simulation.py:527)
DRS_WINDOW = 1.0  # seconds to car ahead (simulation.py:558)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Cars:
    """Batched car state, all arrays (n_sims, D). Mirrors the reference's
    `CarState` dataclass (simulation.py:9-34) as a struct of arrays."""

    cum_time: jax.Array      # f32 cumulative race time
    last_lap: jax.Array      # f32 previous lap time (dirty-air input)
    tire_age: jax.Array      # i32 laps on current tires
    compound: jax.Array      # i32 compound id (config.COMPOUND_NAMES order)
    used_mask: jax.Array     # i32 bitmask of compounds used (2-compound rule)
    fuel: jax.Array          # f32 kg remaining
    pit_stops: jax.Array     # i32
    laps_done: jax.Array     # i32 laps_completed (SC lapped-car grouping)
    dnf: jax.Array           # bool retired
    dnf_lap: jax.Array       # i32 lap of retirement (classification key)
    drs: jax.Array           # bool DRS available this lap
    # NOT carried (deliberately): the reference CarState's `behind_leader`
    # is recomputed as cum_time - current leader time at its only consumer
    # (the dirty-air precompute) — cum/dnf are untouched between the
    # position update that would have stored it and that read, and the
    # race-control rewrites preserve the leader, so the recomputation is
    # exact for every live car while saving an (S, D) f32 scan-carry
    # round-trip through HBM per lap. `start_pos` is likewise only a lap-1
    # input, passed to simulate_lap_1 directly instead of riding the carry.


def _condition_compound(track_condition: jax.Array, remaining: jax.Array) -> jax.Array:
    """Compound choice by condition + remaining laps, shared by pit stops and
    red-flag restarts (simulation.py:414-423 and :465-474)."""
    dry_pick = jnp.where(
        remaining > 30, cfg.HARD, jnp.where(remaining > 15, cfg.MEDIUM, cfg.SOFT)
    )
    return jnp.where(
        track_condition == cfg.FULL_WET,
        cfg.WET,
        jnp.where(track_condition == cfg.DAMP, cfg.INTERMEDIATE, dry_pick),
    ).astype(jnp.int32)


def init_cars(params: SimParams, start_pos: jax.Array) -> Cars:
    """Starting state (reference `_initialize_cars`, simulation.py:244-273).

    Dry: top 10 start on 4-lap-old SOFTs (Q3 tires), rest on fresh MEDIUMs.
    Damp/wet: everyone on fresh INTERMEDIATE/WET.
    """
    shape = start_pos.shape
    top10 = start_pos < 10
    cond = params.track_condition
    dry_compound = jnp.where(top10, cfg.SOFT, cfg.MEDIUM)
    compound = jnp.where(
        cond == cfg.FULL_WET,
        cfg.WET,
        jnp.where(cond == cfg.DAMP, cfg.INTERMEDIATE, dry_compound),
    ).astype(jnp.int32)
    tire_age = jnp.where((cond == cfg.DRY) & top10, 4, 0).astype(jnp.int32)
    zeros_f = jnp.zeros(shape, jnp.float32)
    zeros_i = jnp.zeros(shape, jnp.int32)
    return Cars(
        cum_time=zeros_f,
        last_lap=zeros_f,
        tire_age=tire_age,
        compound=compound,
        used_mask=(1 << compound).astype(jnp.int32),
        fuel=jnp.full(shape, FUEL_START, jnp.float32),
        pit_stops=zeros_i,
        laps_done=zeros_i,
        dnf=jnp.zeros(shape, bool),
        dnf_lap=zeros_i,
        drs=jnp.zeros(shape, bool),
    )


def _clean_lap_time(params: SimParams, cars: Cars, noise: jax.Array) -> jax.Array:
    """Clean-air lap time (reference `_calculate_lap_time`, simulation.py:313-332).

    base + tire_age * (compound_deg * driver_deg/0.05) - burned_fuel*0.03
         + compound_pace_delta - DRS gain + N(0, sigma).
    """
    driver_factor = jnp.where(
        params.tire_deg > 0, params.tire_deg / 0.05, 1.0
    )[None, :]
    eff_deg = params.compound_deg[cars.compound] * driver_factor
    tire_effect = cars.tire_age.astype(jnp.float32) * eff_deg
    fuel_effect = (FUEL_START - cars.fuel) * FUEL_PACE_GAIN
    compound_delta = params.compound_pace[cars.compound]
    drs_gain = jnp.where(cars.drs, params.drs_delta, 0.0)
    return (
        params.base_pace[None, :]
        + tire_effect
        - fuel_effect
        + compound_delta
        - drs_gain
        + params.variance[None, :] * noise
    )


def _active_rank(cars: Cars) -> jax.Array:
    """Rank among non-DNF cars by cumulative time; DNF cars rank last.
    Unique-int-key fast path (ranking.rank_by_unique) — classification keeps
    the exact lexicographic `rank_by`."""
    return rank_by_unique(cars.cum_time, cars.dnf)


def _update_positions(
    params: SimParams, cars: Cars, lap: jax.Array, drs_disabled: jax.Array
) -> tuple[Cars, jax.Array]:
    """End-of-lap position/DRS update (reference simulation.py:538-560).

    Also returns the active rank: nothing modifies cum_time/dnf between this
    update and the next lap's race-control step, so callers carry it forward
    instead of recomputing (one fewer O(D^2) rank per lap)."""
    rank = _active_rank(cars)
    gap_ahead = cars.cum_time - value_of_car_ahead(cars.cum_time, rank, fill=0.0)
    drs_ok = (
        (lap > 2)
        & ~drs_disabled[..., None]
        & (rank > 0)
        & (gap_ahead < DRS_WINDOW)
        & ~cars.dnf
    )
    return dataclasses.replace(cars, drs=drs_ok), rank


def simulate_lap_1(
    params: SimParams, cars: Cars, start_pos: jax.Array, key: jax.Array
) -> tuple[Cars, jax.Array]:
    """Lap 1: 4x team-rate DNF risk, start-position-dependent position
    variance, no DRS (reference `_simulate_lap_1`, simulation.py:275-311).

    `start_pos` is the (n_sims, D) 0-indexed grid slot from grid sampling —
    a lap-1-only input, not part of the carried state."""
    shape = cars.cum_time.shape
    u_dnf = jax.random.uniform(rng.lap_stream(key, 1, rng.STREAM_DNF), shape)
    # Respect pre-retired cars (padding slots beyond the real entry list).
    lap1_dnf = ~cars.dnf & (
        u_dnf < params.team_dnf_rate[None, :] * LAP_1_DNF_MULTIPLIER
    )

    noise = jax.random.normal(rng.lap_stream(key, 1, rng.STREAM_LAP_NOISE), shape)
    base_lap = _clean_lap_time(params, cars, noise)

    # Start model: sigma grows with grid slot; front-3 gains clamped.
    position = start_pos.astype(jnp.float32) + 1.0  # 1-indexed
    sigma = jnp.minimum(1.5, 0.5 + position * 0.1)
    start_noise = jax.random.normal(rng.lap_stream(key, 1, rng.STREAM_START), shape)
    start_delta = sigma * start_noise
    start_delta = jnp.where(position <= 3, jnp.minimum(start_delta, 1.0), start_delta)
    lap_time = base_lap - start_delta * 0.5

    alive = ~cars.dnf & ~lap1_dnf
    cars = dataclasses.replace(
        cars,
        dnf=cars.dnf | lap1_dnf,
        dnf_lap=jnp.where(lap1_dnf, 1, cars.dnf_lap),
        cum_time=jnp.where(alive, cars.cum_time + lap_time, cars.cum_time),
        tire_age=jnp.where(alive, cars.tire_age + 1, cars.tire_age),
        fuel=jnp.where(alive, jnp.maximum(0.0, cars.fuel - FUEL_PER_LAP), cars.fuel),
        # Note: the reference does NOT set last_lap_time or laps_completed on
        # lap 1 (simulation.py:298-305), so lap 2 never sees dirty air.
    )
    return _update_positions(
        params, cars, jnp.int32(1), jnp.ones(shape[:-1], bool)
    )  # -> (cars, rank)


def lap_step(
    params: SimParams,
    total_laps: int,
    cars: Cars,
    drs_until: jax.Array,
    lap: jax.Array,
    key: jax.Array,
    prev_rank: jax.Array | None = None,
) -> tuple[Cars, jax.Array, jax.Array]:
    """One racing lap (laps 2..total_laps), reference simulation.py:164-228.

    `prev_rank` is the active rank from the previous position update (exact,
    since cum/dnf are untouched in between); recomputed when absent. Returns
    (cars, drs_until, rank-after-this-lap)."""
    shape = cars.cum_time.shape
    s = shape[:-1]

    # --- 1. Race control events (red -> SC -> VSC priority chain) ----------
    u = jax.random.uniform(rng.lap_stream(key, lap, rng.STREAM_RACE_CONTROL), s + (3,))
    is_red = u[..., 0] < params.red_flag_prob
    is_sc = ~is_red & (u[..., 1] < params.sc_prob)
    is_vsc = ~is_red & ~is_sc & (u[..., 2] < params.vsc_prob)

    rank = prev_rank if prev_rank is not None else _active_rank(cars)
    active = ~cars.dnf
    key_time = jnp.where(cars.dnf, INF_TIME, cars.cum_time)
    leader_time = jnp.min(key_time, axis=-1, keepdims=True)
    leader_laps = jnp.sum(
        jnp.where((rank == 0) & active, cars.laps_done, 0), axis=-1, keepdims=True
    )
    rank_f = rank.astype(jnp.float32)
    laps_down = (leader_laps - cars.laps_done).astype(jnp.float32)
    sc_time = leader_time + rank_f * SC_GAP + jnp.where(
        laps_down > 0, laps_down * SC_LAPPED_SPACING, 0.0
    )
    vsc_time = leader_time + (cars.cum_time - leader_time) * VSC_GAP_FACTOR
    u_refund = jax.random.uniform(rng.lap_stream(key, lap, rng.STREAM_VSC_REFUND), s)
    vsc_refund = is_vsc & (u_refund < VSC_REFUND_PROB)
    red_time = leader_time + rank_f * RED_FLAG_GAP

    m_red = is_red[..., None] & active
    m_sc = is_sc[..., None] & active
    m_vsc = is_vsc[..., None] & active
    any_event = m_red | m_sc | m_vsc

    cum_time = jnp.where(
        m_red, red_time, jnp.where(m_sc, sc_time, jnp.where(m_vsc, vsc_time, cars.cum_time))
    )
    age_refund = m_sc | (vsc_refund[..., None] & active)
    tire_age = jnp.where(
        m_red, 0, jnp.where(age_refund, jnp.maximum(0, cars.tire_age - 1), cars.tire_age)
    )
    remaining = jnp.asarray(total_laps, jnp.int32) - lap
    red_compound = _condition_compound(params.track_condition, remaining)
    compound = jnp.where(m_red, red_compound, cars.compound)
    used_mask = jnp.where(m_red, cars.used_mask | (1 << red_compound), cars.used_mask)

    drs_until = jnp.where(
        is_red | is_sc, lap + 2, jnp.where(is_vsc, lap + 1, drs_until)
    )
    cars = dataclasses.replace(
        cars,
        cum_time=cum_time,
        tire_age=tire_age,
        compound=compound,
        used_mask=used_mask,
    )

    # --- 2. Dirty-air precompute (simulation.py:179-183) -------------------
    # `rank` is still the current standings: the event rewrites above are
    # monotone in rank among active cars (SC: leader + rank*0.5; VSC: gaps
    # scaled 0.8; red: leader + rank*0.1) and dnf is untouched, so
    # re-ranking the rewritten cum would reproduce `rank` exactly — up to
    # rank-key QUANTIZE ties a fresh re-rank could arbitrate differently:
    # sub-ULP VSC rounding, and (the wider window) red-flag/bunched
    # spacings finer than the integer key's 4-ULP bucket, which exceeds
    # the 0.1 s red-flag gap once cum is above ~5e5 s (reachable inside
    # the validated 15,000 s/lap domain — see ops/ranking.rank_by_unique).
    # Either arbitration only changes which car feeds the dirty-air lookup
    # in those corner states; both engines reuse the carried rank
    # consistently, so the effect is distributionally negligible. Saves
    # one O(D^2) rank build per lap in the scan.
    ahead_last_lap = value_of_car_ahead(cars.last_lap, rank, fill=0.0)

    # --- 3. Per-car DNF draw + lap time (simulation.py:186-228) ------------
    u_dnf = jax.random.uniform(rng.lap_stream(key, lap, rng.STREAM_DNF), shape)
    new_dnf = active & (u_dnf < params.dnf_rate[None, :])
    alive = active & ~new_dnf

    noise = jax.random.normal(rng.lap_stream(key, lap, rng.STREAM_LAP_NOISE), shape)
    clean = _clean_lap_time(params, cars, noise)
    # behind_leader, recomputed (see the Cars docstring): the race-control
    # rewrites preserve the leader (rank-0 term is 0 in all three), so
    # `leader_time` from step 1 is still the leader's cum, and for every
    # live car cum - leader equals the value the reference carries. DNF'd
    # cars get a different (current-gap) value than the reference's frozen
    # one, but their lap time is masked out below either way.
    behind = cars.cum_time - leader_time
    in_dirty_air = (
        (behind > 0)
        & (ahead_last_lap > 0)
        & (behind < params.dirty_air_threshold)
    )
    lap_time = jnp.where(
        in_dirty_air,
        jnp.maximum(clean + params.dirty_air_penalty, ahead_last_lap),
        clean,
    )

    cars = dataclasses.replace(
        cars,
        dnf=cars.dnf | new_dnf,
        dnf_lap=jnp.where(new_dnf, lap, cars.dnf_lap),
        cum_time=jnp.where(alive, cars.cum_time + lap_time, cars.cum_time),
        last_lap=jnp.where(alive, lap_time, cars.last_lap),
        tire_age=jnp.where(alive, cars.tire_age + 1, cars.tire_age),
        fuel=jnp.where(alive, jnp.maximum(0.0, cars.fuel - FUEL_PER_LAP), cars.fuel),
        laps_done=jnp.where(alive, cars.laps_done + 1, cars.laps_done),
    )

    # --- 4. Pit stops (simulation.py:433-494) -------------------------------
    cars = _pit_stops(params, cars, remaining)

    # --- 5. Overtake passes (simulation.py:496-536) -------------------------
    cars = _overtakes(params, cars, rng.lap_stream(key, lap, rng.STREAM_OVERTAKE))

    # --- 6. Position / DRS update (simulation.py:538-560) -------------------
    drs_disabled = lap <= drs_until
    cars, rank_out = _update_positions(params, cars, lap, drs_disabled)
    return cars, drs_until, rank_out


def _pit_stops(params: SimParams, cars: Cars, remaining: jax.Array) -> Cars:
    """Pit when tire age exceeds the (driver-deg adjusted) optimal stint and
    more than 5 laps remain; enforce the mandatory two-dry-compound rule
    (reference `_handle_pit_stops`, simulation.py:433-494)."""
    opt = params.compound_optimal[cars.compound].astype(jnp.float32)
    deg = params.tire_deg[None, :]
    # int() truncation in the reference == floor for positive values.
    opt_adj = jnp.where(
        deg > 0.05,
        jnp.floor(opt * 0.85),
        jnp.where(deg < 0.02, jnp.floor(opt * 1.1), opt),
    ).astype(jnp.int32)
    pit = ~cars.dnf & (cars.tire_age > opt_adj) & (remaining > 5)

    new_compound = _condition_compound(params.track_condition, remaining)

    # Two-compound rule: if exactly one dry compound used so far and the pick
    # repeats it (and conditions are dry), pick a different one.
    used_dry = cars.used_mask & cfg.DRY_COMPOUND_MASK
    n_used_dry = (
        ((used_dry >> cfg.SOFT) & 1) + ((used_dry >> cfg.MEDIUM) & 1) + ((used_dry >> cfg.HARD) & 1)
    )
    is_wet_cond = params.track_condition != cfg.DRY
    must_switch = (
        (n_used_dry == 1)
        & (((used_dry >> new_compound) & 1) == 1)
        & ~is_wet_cond
    )
    medium_available = ((used_dry >> cfg.MEDIUM) & 1) == 0
    soft_available = ((used_dry >> cfg.SOFT) & 1) == 0
    # Deterministic resolution of the reference's set.pop(): long stints
    # prefer MEDIUM then HARD; short stints prefer SOFT then MEDIUM.
    alt = jnp.where(
        remaining > 20,
        jnp.where(medium_available, cfg.MEDIUM, cfg.HARD),
        jnp.where(soft_available, cfg.SOFT, cfg.MEDIUM),
    )
    new_compound = jnp.where(must_switch, alt, new_compound).astype(jnp.int32)

    return dataclasses.replace(
        cars,
        cum_time=jnp.where(pit, cars.cum_time + params.pit_loss, cars.cum_time),
        compound=jnp.where(pit, new_compound, cars.compound),
        used_mask=jnp.where(pit, cars.used_mask | (1 << new_compound), cars.used_mask),
        tire_age=jnp.where(pit, 0, cars.tire_age),
        pit_stops=jnp.where(pit, cars.pit_stops + 1, cars.pit_stops),
    )


def _overtakes(params: SimParams, cars: Cars, key: jax.Array) -> Cars:
    """Up to 3 cascade passes over adjacent time-sorted pairs
    (reference `_simulate_overtakes`, simulation.py:496-536).

    Within a pass, the reference's attempt/success decisions are independent
    of the in-pass time rewrites (eligibility and probability depend only on
    pace, tire age and DRS, all fixed during the pass), so we evaluate all
    pair decisions in parallel and then replay the sequential time-rewrite
    chain with a short unrolled recurrence over positions. The reference
    stops early when a pass produces no overtake — replicated per-simulation
    with a gating flag so later passes consume no effective randomness.
    """
    d = cars.cum_time.shape[-1]
    pace = params.base_pace[None, :] + cars.tire_age.astype(jnp.float32) * params.tire_deg[None, :]

    # DNF gating folds into poisoned pace/bonus values so each pass scatters
    # THREE arrays instead of four (pace, dnf, drs -> pace_p, bonus_p): a
    # -1e30 "ahead" pace makes any pair behind a DNF car ineligible, and a
    # -3e30 DRS bonus makes a DNF attacker ineligible even after the +1e30
    # from its own poisoned pace cancels in. For live pairs both arrays are
    # bitwise the originals and `delta` keeps the exact op order
    # (ahead - pace + bonus), so decisions are bit-identical to the masked
    # form. pace/dnf/drs are all fixed across the 3 passes.
    pace_p = jnp.where(cars.dnf, jnp.float32(-1e30), pace)
    bonus_p = jnp.where(
        cars.dnf,
        jnp.float32(-3e30),
        jnp.where(cars.drs, params.drs_delta, 0.0),
    )

    pass_active = jnp.ones(cars.cum_time.shape[:-1], bool)
    cum = cars.cum_time
    for p in range(OVERTAKE_PASSES):
        # Reference sorts ALL cars (including DNF) by cumulative time.
        rank = rank_by_unique(cum)
        cum_pos = scatter_by_rank(cum, rank)
        pace_pos = scatter_by_rank(pace_p, rank)
        bonus_pos = scatter_by_rank(bonus_p, rank)

        # delta = pace_ahead - pace_behind (+ DRS boost for the car behind);
        # indexed by the BEHIND car's position 1..D-1.
        ahead_pace = jnp.concatenate([pace_pos[..., :1], pace_pos[..., :-1]], axis=-1)
        delta = ahead_pace - pace_pos + bonus_pos
        eligible = (jnp.arange(d) > 0)[None, :] & (delta > params.overtake_delta)
        prob = jnp.minimum(0.5, delta / 2.0)
        u = jax.random.uniform(rng.subkey(key, p), cum_pos.shape)
        swap = eligible & (u < prob) & pass_active[..., None]

        # Sequential time-rewrite chain (exact reference semantics given the
        # same decisions): new_behind = max(0.1, current_ahead - 0.1);
        # ahead becomes new_behind + 0.3. Unrolled over the D-1 pairs.
        cols = [cum_pos[..., i] for i in range(d)]
        for i in range(1, d):
            sw = swap[..., i]
            nb = jnp.maximum(0.1, cols[i - 1] - 0.1)
            cols[i - 1] = jnp.where(sw, nb + OVERTAKE_RESET_GAP, cols[i - 1])
            cols[i] = jnp.where(sw, nb, cols[i])
        cum_pos = jnp.stack(cols, axis=-1)
        cum = gather_at_rank(cum_pos, rank)
        pass_active = pass_active & jnp.any(swap, axis=-1)

    return dataclasses.replace(cars, cum_time=cum)


def classify(cars: Cars) -> jax.Array:
    """Final 1-indexed positions (reference simulation.py:230-242):
    finishers by cumulative time, then DNFs by (retirement lap, cumulative
    time) descending. Runs once per race, so it keeps the EXACT
    (value, index)-lexicographic rank rather than the 4-ULP-quantized
    fast path used per lap."""
    active_rank = rank_by(jnp.where(cars.dnf, INF_TIME, cars.cum_time))
    n_active = jnp.sum(~cars.dnf, axis=-1, keepdims=True)

    # DNF rank: descending lexicographic (lap, cum_time), stable.
    lap_i = cars.dnf_lap[..., :, None]
    lap_j = cars.dnf_lap[..., None, :]
    cum_i = cars.cum_time[..., :, None]
    cum_j = cars.cum_time[..., None, :]
    d = cars.cum_time.shape[-1]
    idx = jnp.arange(d, dtype=jnp.int32)
    greater = (lap_j > lap_i) | (
        (lap_j == lap_i)
        & ((cum_j > cum_i) | ((cum_j == cum_i) & (idx[None, :] < idx[:, None])))
    )
    both_dnf = cars.dnf[..., :, None] & cars.dnf[..., None, :]
    dnf_rank = jnp.sum(greater & both_dnf, axis=-1, dtype=jnp.int32)

    return jnp.where(cars.dnf, n_active + dnf_rank, active_rank) + 1
