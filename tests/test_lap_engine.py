"""Unit tests for every event-model rule in the lap engine, driven directly
through `lap_step`/`init_cars`/`classify` with crafted states. Each test
pins one rule from SURVEY.md §2's simulation event model (reference
simulation.py line refs in the engine docstrings)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from monte_carlo_gp import config as cfg
from monte_carlo_gp.config import make_sim_params
from monte_carlo_gp.ops.lap_engine import classify, init_cars, lap_step

KEY = jax.random.PRNGKey(123)


def quiet_params(d=4, **overrides):
    """Params with all stochastic effects off: no noise, no events, no DNFs,
    no overtakes, no dirty air, no pit stops (huge optimal stints)."""
    compound_table = {
        name: dict(info) for name, info in cfg.TIRE_COMPOUNDS.items()
    }
    for info in compound_table.values():
        info["optimal_laps"] = 10_000
    defaults = dict(
        grid_probs=np.eye(d, dtype=np.float32),
        base_pace=np.full(d, 90.0, np.float32),
        tire_deg=np.full(d, 0.05, np.float32),
        variance=np.zeros(d, np.float32),
        dnf_rate=np.zeros(d, np.float32),
        team_dnf_rate=np.zeros(d, np.float32),
        sc_prob=0.0,
        vsc_prob=0.0,
        red_flag_prob=0.0,
        overtake_delta=1e9,
        dirty_air_threshold=0.0,
        pit_loss=21.0,
        compound_table=compound_table,
    )
    defaults.update(overrides)
    return make_sim_params(**defaults)


def fresh_cars(params, gaps, **overrides):
    """One-sim Cars state: car i starts grid slot i with cum_time gaps[i]."""
    d = len(gaps)
    cars = init_cars(params, jnp.arange(d, dtype=jnp.int32)[None, :])
    cum = jnp.asarray([gaps], jnp.float32)
    cars = dataclasses.replace(
        cars, cum_time=cum, laps_done=jnp.ones_like(cars.laps_done),
    )
    return dataclasses.replace(cars, **overrides)


import functools


@functools.partial(jax.jit, static_argnums=(1,))
def _jit_step(params, total_laps, cars, d0, lap):
    cars, drs_until, _rank = lap_step(params, total_laps, cars, d0, lap, KEY)
    return cars, drs_until


def step(params, cars, lap=10, total_laps=57, drs_until=0):
    d0 = jnp.full(cars.cum_time.shape[:-1], drs_until, jnp.int32)
    return _jit_step(params, total_laps, cars, d0, jnp.int32(lap))


# ---------------------------------------------------------------------------
# init_cars (simulation.py:244-273)
# ---------------------------------------------------------------------------


def test_init_dry_tires():
    params = quiet_params(d=12)
    cars = init_cars(params, jnp.arange(12)[None, :])
    comp = np.asarray(cars.compound)[0]
    age = np.asarray(cars.tire_age)[0]
    assert (comp[:10] == cfg.SOFT).all() and (comp[10:] == cfg.MEDIUM).all()
    assert (age[:10] == 4).all() and (age[10:] == 0).all()
    assert (np.asarray(cars.fuel)[0] == 110.0).all()
    np.testing.assert_array_equal(
        np.asarray(cars.used_mask)[0], 1 << comp
    )


def test_init_wet_and_damp_tires():
    for cond, comp_expected in (("wet", cfg.WET), ("damp", cfg.INTERMEDIATE)):
        params = quiet_params(d=12, track_condition=cond)
        cars = init_cars(params, jnp.arange(12)[None, :])
        assert (np.asarray(cars.compound)[0] == comp_expected).all()
        assert (np.asarray(cars.tire_age)[0] == 0).all()


# ---------------------------------------------------------------------------
# Lap-time model (simulation.py:313-332)
# ---------------------------------------------------------------------------


def test_lap_time_formula_exact():
    params = quiet_params(d=4, tire_deg=np.array([0.05, 0.10, 0.0, 0.05], np.float32))
    cars = fresh_cars(params, [0.0, 10.0, 20.0, 30.0])
    cars = dataclasses.replace(
        cars,
        tire_age=jnp.asarray([[3, 5, 2, 0]], jnp.int32),
        fuel=jnp.asarray([[110.0, 100.0, 95.0, 110.0]], jnp.float32),
        compound=jnp.asarray([[cfg.SOFT, cfg.MEDIUM, cfg.HARD, cfg.WET]], jnp.int32),
    )
    before = np.asarray(cars.cum_time)[0].copy()
    out, _ = step(params, cars)
    lap_times = np.asarray(out.cum_time)[0] - before
    # base + age * comp_deg * (deg/0.05 or 1.0) - burned*0.03 + comp_pace
    expected = np.array([
        90.0 + 3 * 0.08 * 1.0 - 0.0 + (-0.8),
        90.0 + 5 * 0.05 * 2.0 - 10 * 0.03 + 0.0,
        90.0 + 2 * 0.03 * 1.0 - 15 * 0.03 + 0.6,   # deg=0 -> factor 1.0
        90.0 + 0 - 0.0 + 10.0,
    ])
    np.testing.assert_allclose(lap_times, expected, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.tire_age)[0], [4, 6, 3, 1])
    np.testing.assert_allclose(
        np.asarray(out.fuel)[0], [108.5, 98.5, 93.5, 108.5], rtol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(out.laps_done)[0], [2, 2, 2, 2])


def test_drs_gain_applied():
    params = quiet_params(d=2)
    base = fresh_cars(params, [0.0, 30.0])
    with_drs = dataclasses.replace(base, drs=jnp.asarray([[False, True]]))
    out0, _ = step(params, base)
    out1, _ = step(params, with_drs)
    lt0 = np.asarray(out0.cum_time - base.cum_time)[0]
    lt1 = np.asarray(out1.cum_time - with_drs.cum_time)[0]
    assert abs(lt0[1] - lt1[1] - 0.3) < 1e-5  # DRS car gains drs_delta
    assert abs(lt0[0] - lt1[0]) < 1e-6


# ---------------------------------------------------------------------------
# Dirty air (simulation.py:179-216)
# ---------------------------------------------------------------------------


def test_dirty_air_clamps_to_car_ahead():
    params = quiet_params(d=2, dirty_air_threshold=2.0)
    cars = fresh_cars(params, [0.0, 1.0])
    cars = dataclasses.replace(
        cars, last_lap=jnp.asarray([[95.0, 90.0]], jnp.float32)
    )
    out, _ = step(params, cars)
    lap_times = np.asarray(out.cum_time - cars.cum_time)[0]
    # car 1: clean=89.52 (SOFT delta, 4-lap-old tires) +0.5 < 95 -> held to 95
    assert abs(lap_times[1] - 95.0) < 1e-5
    assert abs(lap_times[0] - 89.52) < 1e-4  # leader unaffected


def test_dirty_air_penalty_when_ahead_is_slower_history():
    params = quiet_params(d=2, dirty_air_threshold=2.0)
    cars = fresh_cars(params, [0.0, 1.0])
    cars = dataclasses.replace(
        cars, last_lap=jnp.asarray([[10.0, 90.0]], jnp.float32)
    )
    out, _ = step(params, cars)
    lap_times = np.asarray(out.cum_time - cars.cum_time)[0]
    # max(clean + 0.5, 10.0) = clean + 0.5
    assert abs(lap_times[1] - (89.52 + 0.5)) < 1e-4


def test_no_dirty_air_outside_threshold_or_without_history():
    params = quiet_params(d=2, dirty_air_threshold=2.0)
    # gap 5s > threshold
    far = fresh_cars(params, [0.0, 5.0])
    far = dataclasses.replace(far, last_lap=jnp.asarray([[95.0, 90.0]], jnp.float32))
    out, _ = step(params, far)
    assert abs(np.asarray(out.cum_time - far.cum_time)[0][1] - 89.52) < 1e-4
    # ahead has no recorded lap (lap-2 semantics: last_lap==0)
    near = fresh_cars(params, [0.0, 1.0])
    out, _ = step(params, near)
    assert abs(np.asarray(out.cum_time - near.cum_time)[0][1] - 89.52) < 1e-4


# ---------------------------------------------------------------------------
# DNF + classification (simulation.py:190-197, :230-242)
# ---------------------------------------------------------------------------


def test_forced_dnf_freezes_car():
    params = quiet_params(d=3, dnf_rate=np.array([0.0, 1.0, 0.0], np.float32))
    cars = fresh_cars(params, [0.0, 1.0, 2.0])
    out, _ = step(params, cars, lap=7)
    assert np.asarray(out.dnf)[0].tolist() == [False, True, False]
    assert np.asarray(out.dnf_lap)[0][1] == 7
    assert np.asarray(out.cum_time)[0][1] == 1.0  # no time added
    assert np.asarray(out.laps_done)[0][1] == 1


def test_classification_order():
    params = quiet_params(d=5)
    cars = fresh_cars(params, [100.0, 50.0, 75.0, 60.0, 80.0])
    cars = dataclasses.replace(
        cars,
        dnf=jnp.asarray([[False, True, False, True, True]]),
        dnf_lap=jnp.asarray([[0, 30, 0, 30, 40]], jnp.int32),
    )
    pos = np.asarray(classify(cars))[0]
    # Active by time: car0 (100) ... wait car2=75 < car0=100 -> car2 P1, car0 P2.
    # DNFs by (lap desc, cum desc): car4 (40) P3, then lap-30 tie by cum desc:
    # car3 (60) vs car1 (50) -> car3 P4, car1 P5.
    np.testing.assert_array_equal(pos, [2, 5, 1, 4, 3])


# ---------------------------------------------------------------------------
# Pit stops + two-compound rule (simulation.py:433-494)
# ---------------------------------------------------------------------------


def pit_params(d=3, **kw):
    return quiet_params(d=d, compound_table=None, **kw)  # real optimal laps


def test_pit_triggers_and_compound_choice():
    params = pit_params(d=3)
    cars = fresh_cars(params, [0.0, 0.0, 0.0])
    cars = dataclasses.replace(
        cars,
        compound=jnp.asarray([[cfg.SOFT, cfg.SOFT, cfg.SOFT]], jnp.int32),
        used_mask=jnp.asarray([[1 << cfg.SOFT] * 3], jnp.int32),
        tire_age=jnp.asarray([[15, 15, 15]], jnp.int32),
    )
    # after this lap: age=16 > optimal 15 -> pit. remaining = 57 - lap.
    out, _ = step(params, cars, lap=20, total_laps=57)  # remaining 37 -> HARD
    assert (np.asarray(out.pit_stops)[0] == 1).all()
    assert (np.asarray(out.compound)[0] == cfg.HARD).all()
    assert (np.asarray(out.tire_age)[0] == 0).all()
    out2, _ = step(params, cars, lap=30, total_laps=57)  # remaining 27 -> MEDIUM
    assert (np.asarray(out2.compound)[0] == cfg.MEDIUM).all()
    out3, _ = step(params, cars, lap=45, total_laps=57)  # remaining 12 -> SOFT
    # two-compound rule: SOFT already used and is the only dry compound ->
    # must switch; remaining <= 20 and SOFT unavailable -> MEDIUM
    assert (np.asarray(out3.compound)[0] == cfg.MEDIUM).all()


def test_pit_deg_adjusted_optimal():
    # high-deg driver pits earlier (0.85x), tire whisperer later (1.1x)
    params = pit_params(d=3, tire_deg=np.array([0.10, 0.05, 0.015], np.float32))
    cars = fresh_cars(params, [0.0, 0.0, 0.0])
    cars = dataclasses.replace(
        cars,
        compound=jnp.asarray([[cfg.MEDIUM] * 3], jnp.int32),
        used_mask=jnp.asarray([[1 << cfg.MEDIUM] * 3], jnp.int32),
        tire_age=jnp.asarray([[21, 21, 21]], jnp.int32),
    )
    # after lap: age 22. thresholds: int(25*0.85)=21 -> pit; 25 -> no; int(27.5)=27 -> no
    out, _ = step(params, cars, lap=20)
    np.testing.assert_array_equal(np.asarray(out.pit_stops)[0], [1, 0, 0])


def test_no_pit_when_few_laps_remain():
    params = pit_params(d=1)
    cars = fresh_cars(params, [0.0])
    cars = dataclasses.replace(
        cars,
        compound=jnp.asarray([[cfg.SOFT]], jnp.int32),
        tire_age=jnp.asarray([[30]], jnp.int32),
    )
    out, _ = step(params, cars, lap=53, total_laps=57)  # remaining 4 <= 5
    assert np.asarray(out.pit_stops)[0][0] == 0


def test_two_compound_rule_forces_switch():
    params = pit_params(d=1)
    cars = fresh_cars(params, [0.0])
    cars = dataclasses.replace(
        cars,
        compound=jnp.asarray([[cfg.MEDIUM]], jnp.int32),
        used_mask=jnp.asarray([[1 << cfg.MEDIUM]], jnp.int32),
        tire_age=jnp.asarray([[26]], jnp.int32),
    )
    # remaining 27 -> natural pick MEDIUM, but only MEDIUM used -> alt.
    # remaining > 20 and MEDIUM unavailable -> HARD.
    out, _ = step(params, cars, lap=30, total_laps=57)
    assert np.asarray(out.compound)[0][0] == cfg.HARD
    assert np.asarray(out.used_mask)[0][0] == (1 << cfg.MEDIUM) | (1 << cfg.HARD)


# ---------------------------------------------------------------------------
# Race control events (simulation.py:334-431)
# ---------------------------------------------------------------------------


def test_safety_car_bunches_field():
    params = quiet_params(d=4, sc_prob=1.0)
    cars = fresh_cars(params, [0.0, 10.0, 20.0, 30.0])
    age0 = np.asarray(cars.tire_age)[0].copy()
    out, _ = step(params, cars, lap=10)
    cum = np.asarray(out.cum_time)[0]
    # bunched to 0.5s/position, then one identical lap added -> exact gaps.
    # (cars are identical: same compound/age/pace; dirty air disabled)
    gaps = cum - cum.min()
    np.testing.assert_allclose(np.sort(gaps), [0.0, 0.5, 1.0, 1.5], atol=1e-5)
    # tire age: -1 refund then +1 for the racing lap -> unchanged
    np.testing.assert_array_equal(np.asarray(out.tire_age)[0], age0)


def test_sc_keeps_lapped_cars_lapped():
    params = quiet_params(d=3, sc_prob=1.0)
    cars = fresh_cars(params, [0.0, 10.0, 200.0])
    cars = dataclasses.replace(
        cars, laps_done=jnp.asarray([[10, 10, 8]], jnp.int32)
    )
    out, _ = step(params, cars, lap=12)
    cum = np.asarray(out.cum_time)[0]
    # car 2 is 2 laps down: leader + 2*90 + rank*0.5
    assert cum[2] - cum[0] > 170.0


def test_vsc_scales_gaps():
    params = quiet_params(d=3, vsc_prob=1.0)
    cars = fresh_cars(params, [0.0, 10.0, 20.0])
    out, _ = step(params, cars, lap=10)
    cum = np.asarray(out.cum_time)[0]
    np.testing.assert_allclose(cum - cum[0], [0.0, 8.0, 16.0], atol=1e-5)


def test_red_flag_resets_gaps_and_tires():
    params = quiet_params(d=3, red_flag_prob=1.0)
    cars = fresh_cars(params, [0.0, 10.0, 20.0])
    cars = dataclasses.replace(cars, tire_age=jnp.asarray([[20, 20, 20]], jnp.int32))
    out, _ = step(params, cars, lap=10, total_laps=57)  # remaining 47 -> HARD
    cum = np.asarray(out.cum_time)[0]
    np.testing.assert_allclose(cum - cum[0], [0.0, 0.1, 0.2], atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.tire_age)[0], [1, 1, 1])
    assert (np.asarray(out.compound)[0] == cfg.HARD).all()
    assert (np.asarray(out.used_mask)[0] & (1 << cfg.HARD)).all()


def test_event_priority_red_over_sc():
    params = quiet_params(d=3, red_flag_prob=1.0, sc_prob=1.0, vsc_prob=1.0)
    cars = fresh_cars(params, [0.0, 10.0, 20.0])
    out, _ = step(params, cars, lap=10)
    cum = np.asarray(out.cum_time)[0]
    # red-flag gaps (0.1), not SC gaps (0.5)
    np.testing.assert_allclose(cum - cum[0], [0.0, 0.1, 0.2], atol=1e-5)


# ---------------------------------------------------------------------------
# DRS window (simulation.py:538-560)
# ---------------------------------------------------------------------------


def test_drs_awarded_within_window():
    params = quiet_params(d=3)
    cars = fresh_cars(params, [0.0, 0.5, 5.0])
    out, _ = step(params, cars, lap=10)
    drs = np.asarray(out.drs)[0]
    assert drs.tolist() == [False, True, False]  # leader never; 0.5s gap yes


def test_drs_disabled_after_sc_until_expiry():
    params = quiet_params(d=2)
    cars = fresh_cars(params, [0.0, 0.5])
    out, _ = step(params, cars, lap=10, drs_until=10)
    assert not np.asarray(out.drs)[0].any()
    out2, _ = step(params, cars, lap=11, drs_until=10)
    assert np.asarray(out2.drs)[0][1]


def test_drs_never_on_early_laps():
    params = quiet_params(d=2)
    cars = fresh_cars(params, [0.0, 0.5])
    out, _ = step(params, cars, lap=2)
    assert not np.asarray(out.drs)[0].any()


# ---------------------------------------------------------------------------
# Overtakes (simulation.py:496-536)
# ---------------------------------------------------------------------------


def test_overtake_success_rate_and_time_rewrite():
    d = 2
    # behind car 1.2s/lap faster -> delta 1.2 > 0.6, prob = min(.5, .6) = 0.5
    params = quiet_params(
        d=d,
        base_pace=np.array([91.2, 90.0], np.float32),
        overtake_delta=0.6,
        dirty_air_threshold=0.0,
    )
    n = 4000
    cars = init_cars(params, jnp.tile(jnp.arange(d), (n, 1)))
    cum = jnp.tile(jnp.asarray([[0.0, 3.0]], jnp.float32), (n, 1))
    cars = dataclasses.replace(
        cars,
        cum_time=cum,
        compound=jnp.full((n, d), cfg.MEDIUM, jnp.int32),
        tire_age=jnp.zeros((n, d), jnp.int32),
        laps_done=jnp.ones((n, d), jnp.int32),
    )
    d0 = jnp.zeros((n,), jnp.int32)
    out, _ = _jit_step(params, 57, cars, d0, jnp.int32(10))
    # both cars run identical 90-ish... car0 pace 91.2 (slower), car1 90.0.
    # lap times: car0 = 91.2, car1 = 90.0, so pre-overtake car1 closes to
    # 3.0 - 1.2 = 1.8s. Overtake: delta = 1.2 > 0.6 with prob 0.5.
    cum_out = np.asarray(out.cum_time)
    swapped = cum_out[:, 1] < cum_out[:, 0]
    rate = swapped.mean()
    assert 0.45 < rate < 0.55, rate
    # time rewrite: new_behind = ahead_cum - 0.1; ahead = new_behind + 0.3
    gaps = cum_out[swapped, 0] - cum_out[swapped, 1]
    np.testing.assert_allclose(gaps, 0.3, atol=1e-4)


def test_no_overtake_below_delta_threshold():
    params = quiet_params(
        d=2,
        base_pace=np.array([90.5, 90.0], np.float32),
        overtake_delta=0.6,  # delta 0.5 < 0.6
        dirty_air_threshold=0.0,
    )
    n = 512
    cars = init_cars(params, jnp.tile(jnp.arange(2), (n, 1)))
    cum = jnp.tile(jnp.asarray([[0.0, 3.0]], jnp.float32), (n, 1))
    cars = dataclasses.replace(
        cars, cum_time=cum,
        laps_done=jnp.ones((n, 2), jnp.int32),
    )
    out, _ = _jit_step(params, 57, cars, jnp.zeros((n, ), jnp.int32), jnp.int32(10))
    cum_out = np.asarray(out.cum_time)
    assert (cum_out[:, 0] < cum_out[:, 1]).all()


# ---------------------------------------------------------------------------
# Boundary conditions
# ---------------------------------------------------------------------------


def test_drs_window_is_strict():
    """DRS requires gap strictly < 1.0s (simulation.py:558)."""
    params = quiet_params(d=3)
    cars = fresh_cars(params, [0.0, 1.0, 1.5])
    out, _ = step(params, cars, lap=10)
    # identical pace cars -> gaps preserved: exactly 1.0 -> no DRS; 0.5 -> DRS
    drs = np.asarray(out.drs)[0]
    assert drs.tolist() == [False, False, True]


def test_pit_boundary_remaining_exactly_six():
    """Pit requires remaining > 5: remaining == 6 pits, remaining == 5 not."""
    params = pit_params(d=1)
    cars = fresh_cars(params, [0.0])
    cars = dataclasses.replace(
        cars,
        compound=jnp.asarray([[cfg.SOFT]], jnp.int32),
        tire_age=jnp.asarray([[30]], jnp.int32),
    )
    out6, _ = step(params, cars, lap=51, total_laps=57)  # remaining 6
    assert np.asarray(out6.pit_stops)[0][0] == 1
    out5, _ = step(params, cars, lap=52, total_laps=57)  # remaining 5
    assert np.asarray(out5.pit_stops)[0][0] == 0


def test_red_flag_near_race_end_picks_soft():
    """remaining <= 15 -> SOFT at a red-flag restart (simulation.py:419-423)."""
    params = quiet_params(d=2, red_flag_prob=1.0)
    cars = fresh_cars(params, [0.0, 5.0])
    out, _ = step(params, cars, lap=50, total_laps=57)  # remaining 7
    assert (np.asarray(out.compound)[0] == cfg.SOFT).all()


def test_all_cars_dnf_classification():
    """Everyone retired: classification orders purely by (lap desc, cum desc)."""
    params = quiet_params(d=4)
    cars = fresh_cars(params, [10.0, 20.0, 30.0, 40.0])
    cars = dataclasses.replace(
        cars,
        dnf=jnp.asarray([[True, True, True, True]]),
        dnf_lap=jnp.asarray([[5, 9, 9, 2]], jnp.int32),
    )
    pos = np.asarray(classify(cars))[0]
    # lap 9 ties broken by cum desc: car2 (30) before car1 (20); then 5, then 2
    np.testing.assert_array_equal(pos, [3, 2, 1, 4])


def test_overtake_probability_caps_at_half():
    """delta/2 > 0.5 still succeeds at most 50% (simulation.py:524)."""
    params = quiet_params(
        d=2,
        base_pace=np.array([95.0, 90.0], np.float32),  # delta 5.0 -> prob cap
        overtake_delta=0.6,
        dirty_air_threshold=0.0,
    )
    n = 4000
    cars = init_cars(params, jnp.tile(jnp.arange(2), (n, 1)))
    # gap 10s: one lap of 5s/lap raw pace difference cannot close it, so a
    # position change can only come from the overtake step
    cum = jnp.tile(jnp.asarray([[0.0, 10.0]], jnp.float32), (n, 1))
    cars = dataclasses.replace(
        cars, cum_time=cum,
        laps_done=jnp.ones((n, 2), jnp.int32),
    )
    out, _ = _jit_step(params, 57, cars, jnp.zeros((n,), jnp.int32), jnp.int32(10))
    cum_out = np.asarray(out.cum_time)
    # prob = min(0.5, 5/2) caps at 0.5; with a single pair, a failed first
    # pass ends the cascade (reference early break), so overall ~0.5
    rate = (cum_out[:, 1] < cum_out[:, 0]).mean()
    assert 0.45 < rate < 0.55, rate


def test_vsc_refund_is_about_30_percent():
    params = quiet_params(d=2, vsc_prob=1.0)
    n = 4000
    cars = init_cars(params, jnp.tile(jnp.arange(2), (n, 1)))
    cars = dataclasses.replace(
        cars,
        cum_time=jnp.tile(jnp.asarray([[0.0, 10.0]], jnp.float32), (n, 1)),
        tire_age=jnp.full((n, 2), 10, jnp.int32),
        laps_done=jnp.ones((n, 2), jnp.int32),
    )
    out, _ = _jit_step(params, 57, cars, jnp.zeros((n,), jnp.int32), jnp.int32(10))
    # refund: age 10-1+1 = 10 (refund then +1 for the lap); no refund: 11
    refunded = (np.asarray(out.tire_age)[:, 0] == 10).mean()
    assert 0.25 < refunded < 0.35, refunded


def test_overtake_poison_fold_matches_masked_form():
    """The DNF/DRS poison fold in `_overtakes` (three scatters per pass
    instead of four) must be bit-identical to the explicit-mask form it
    replaced, across random states with retired cars and DRS holders."""
    from monte_carlo_gp.ops import rng as _rng
    from monte_carlo_gp.ops.lap_engine import (
        OVERTAKE_PASSES,
        OVERTAKE_RESET_GAP,
        _overtakes,
    )
    from monte_carlo_gp.ops.ranking import (
        gather_at_rank,
        rank_by_unique,
        scatter_by_rank,
    )

    def masked_overtakes(params, cars, key):
        # the pre-fold formulation, verbatim semantics
        d = cars.cum_time.shape[-1]
        pace = (
            params.base_pace[None, :]
            + cars.tire_age.astype(jnp.float32) * params.tire_deg[None, :]
        )
        pass_active = jnp.ones(cars.cum_time.shape[:-1], bool)
        cum = cars.cum_time
        for p in range(OVERTAKE_PASSES):
            rank = rank_by_unique(cum)
            cum_pos = scatter_by_rank(cum, rank)
            pace_pos = scatter_by_rank(pace, rank)
            dnf_pos = scatter_by_rank(cars.dnf, rank)
            drs_pos = scatter_by_rank(cars.drs, rank)
            ahead_pace = jnp.concatenate(
                [pace_pos[..., :1], pace_pos[..., :-1]], axis=-1
            )
            ahead_dnf = jnp.concatenate(
                [dnf_pos[..., :1], dnf_pos[..., :-1]], axis=-1
            )
            delta = ahead_pace - pace_pos + jnp.where(drs_pos, params.drs_delta, 0.0)
            eligible = (
                (jnp.arange(d) > 0)[None, :]
                & ~dnf_pos
                & ~ahead_dnf
                & (delta > params.overtake_delta)
            )
            prob = jnp.minimum(0.5, delta / 2.0)
            u = jax.random.uniform(_rng.subkey(key, p), cum_pos.shape)
            swap = eligible & (u < prob) & pass_active[..., None]
            cols = [cum_pos[..., i] for i in range(d)]
            for i in range(1, d):
                sw = swap[..., i]
                nb = jnp.maximum(0.1, cols[i - 1] - 0.1)
                cols[i - 1] = jnp.where(sw, nb + OVERTAKE_RESET_GAP, cols[i - 1])
                cols[i] = jnp.where(sw, nb, cols[i])
            cum_pos = jnp.stack(cols, axis=-1)
            cum = gather_at_rank(cum_pos, rank)
            pass_active = pass_active & jnp.any(swap, axis=-1)
        return cum

    d, n = 12, 256
    nprng = np.random.default_rng(11)
    params = quiet_params(
        d=d,
        base_pace=(90.0 + 2.0 * nprng.standard_normal(d)).astype(np.float32),
        tire_deg=np.clip(0.05 + 0.02 * nprng.standard_normal(d), 0.01, 0.15),
        overtake_delta=0.4,
    )
    cars = init_cars(params, jnp.tile(jnp.arange(d), (n, 1)))
    cars = dataclasses.replace(
        cars,
        cum_time=jnp.asarray(
            np.cumsum(nprng.uniform(0.1, 3.0, (n, d)), axis=1), jnp.float32
        ),
        tire_age=jnp.asarray(nprng.integers(0, 30, (n, d)), jnp.int32),
        dnf=jnp.asarray(nprng.uniform(size=(n, d)) < 0.15),
        drs=jnp.asarray(nprng.uniform(size=(n, d)) < 0.4),
    )
    key = jax.random.PRNGKey(21)
    folded = np.asarray(_overtakes(params, cars, key).cum_time)
    masked = np.asarray(masked_overtakes(params, cars, key))
    np.testing.assert_array_equal(folded, masked)
    # the poisoning must actually have been exercised
    assert bool(np.asarray(cars.dnf).any()) and bool(np.asarray(cars.drs).any())
