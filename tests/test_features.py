"""Feature engine: formula checks on hand-crafted archives + smoke over the
synthetic dataset (clamps, defaults, ranges)."""

import numpy as np
import pandas as pd
import pytest

from monte_carlo_gp.data.loader import F1DataLoader
from monte_carlo_gp.data.synthetic import SyntheticBackend
from monte_carlo_gp.models.features import F1FeatureEngine


def make_engine(laps=None, results=None):
    eng = F1FeatureEngine(data_loader=None)
    eng.laps = laps if laps is not None else pd.DataFrame()
    eng.race_results = results if results is not None else pd.DataFrame()
    return eng


def lap_rows(driver, team, season, circuit, session, times, sectors=None, **kw):
    rows = []
    for i, t in enumerate(times):
        s = sectors[i] if sectors else (t * 0.3, t * 0.38, t * 0.32)
        rows.append(
            dict(
                Driver=driver, Team=team, season=season, circuit=circuit,
                session_type=session, LapTime=t, LapNumber=i + 1,
                Sector1Time=s[0], Sector2Time=s[1], Sector3Time=s[2],
                Compound="SOFT", IsAccurate=True, TrackTemp=kw.get("temp", 35.0),
                Rainfall=kw.get("rain", False), Position=np.nan,
            )
        )
    return rows


def results_rows(driver, entries, season=2024):
    return [
        dict(driver=driver, grid=g, finish=f, status=s, season=season,
             circuit=f"C{i}")
        for i, (g, f, s) in enumerate(entries)
    ]


# -- defaults on empty archives ------------------------------------------------


def test_empty_archive_defaults():
    eng = make_engine()
    q = eng.calculate_quali_features("VER", "Bahrain")
    assert q["avg_gap_to_pole_pct"] == 1.5
    assert q["teammate_delta"] == 0.0
    assert q["q3_conversion"] == 0.5
    assert q["form_score"] == 0.0
    r = eng.calculate_race_features("VER", "Bahrain", {"rainfall": False, "track_temp": 40})
    assert r["deg_rate"] == 0.05
    assert r["position_hold_rate"] == 0.7
    assert r["dnf_probability"] == 0.05
    assert r["wet_performance"] == 0
    assert r["high_temp_deg"] == pytest.approx(0.001 * 40)


# -- qualifying features ---------------------------------------------------------


def test_teammate_delta_direction():
    laps = pd.DataFrame(
        lap_rows("FAST", "T1", 2024, "Bahrain GP", "Q", [89.0, 88.5])
        + lap_rows("SLOW", "T1", 2024, "Bahrain GP", "Q", [90.0, 89.5])
    )
    eng = make_engine(laps)
    fast = eng.calculate_quali_features("FAST", "Bahrain")["teammate_delta"]
    slow = eng.calculate_quali_features("SLOW", "Bahrain")["teammate_delta"]
    # (89.5 - 88.5)/89.5*100 ~ 1.117
    assert fast == pytest.approx((89.5 - 88.5) / 89.5 * 100, rel=1e-5)
    assert slow < 0 < fast


def test_q3_rate_lap_count_heuristic():
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "R1", "Q", [90, 91, 92])     # 3 laps -> Q3
        + lap_rows("A", "T", 2024, "R2", "Q", [90, 91])        # 2 laps -> no
    )
    eng = make_engine(laps)
    assert eng.calculate_quali_features("A", "Bahrain")["q3_conversion"] == 0.5


def test_form_score_decay_weighting():
    # Session gaps: older 2% (score -1), newer 0% (score 1); decay 0.85
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "R1", "Q", [91.8])
        + lap_rows("B", "T", 2024, "R1", "Q", [90.0])
        + lap_rows("A", "T", 2024, "R2", "Q", [90.0])
        + lap_rows("B", "T", 2024, "R2", "Q", [90.5])
    )
    eng = make_engine(laps)
    score = eng.calculate_quali_features("A", "Bahrain")["form_score"]
    w_old, w_new = 0.85, 1.0
    expected = (-1.0 * w_old + 1.0 * w_new) / (w_old + w_new)
    assert score == pytest.approx(expected, rel=1e-4)


def test_sector_strength_clamped():
    sectors_fast = [(26.0, 33.0, 28.0)]
    sectors_slow = [(27.0, 34.0, 29.0)]
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "R1", "Q", [87.0], sectors=sectors_fast)
        + lap_rows("B", "T", 2024, "R1", "Q", [90.0], sectors=sectors_slow)
    )
    eng = make_engine(laps)
    a = eng.calculate_quali_features("A", "Bahrain")
    b = eng.calculate_quali_features("B", "Bahrain")
    assert a["high_speed_strength"] == 0.0  # A holds the best S1
    # B is 1/26 ~ 3.8% slower -> clamped to -1
    assert b["high_speed_strength"] == -1.0


def test_circuit_affinity_sign():
    # driver faster at street circuits than their overall average
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "Monaco Grand Prix", "Q", [70.0, 70.0])
        + lap_rows("A", "T", 2024, "Italy Grand Prix", "Q", [95.0, 95.0])
    )
    eng = make_engine(laps)
    aff = eng.calculate_quali_features("A", "Monaco Grand Prix")["circuit_affinity"]
    # overall avg 82.5, Monaco avg 70 -> (82.5-70)/82.5
    assert aff == pytest.approx((82.5 - 70) / 82.5)
    aff2 = eng.calculate_quali_features("A", "Italy Grand Prix")["circuit_affinity"]
    assert aff2 == pytest.approx((82.5 - 95) / 82.5)


# -- race features ---------------------------------------------------------------


def test_race_pace_delta():
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "R1", "R", [90.0] * 6)
        + lap_rows("B", "T", 2024, "R1", "R", [91.8] * 6)
    )
    eng = make_engine(laps)
    w = {"rainfall": False, "track_temp": 35}
    assert eng.calculate_race_features("A", "x", w)["race_pace_delta"] == 0.0
    assert eng.calculate_race_features("B", "x", w)["race_pace_delta"] == pytest.approx(2.0)


def test_deg_rate_slope_and_clamp():
    times = [90.0 + 0.08 * i for i in range(20)]
    laps = pd.DataFrame(lap_rows("A", "T", 2024, "R1", "R", times))
    eng = make_engine(laps)
    w = {"rainfall": False, "track_temp": 35}
    assert eng.calculate_race_features("A", "x", w)["deg_rate"] == pytest.approx(0.08, abs=5e-3)
    # extreme slope clamps to 0.15
    times = [90.0 + 0.4 * i for i in range(20)]
    eng2 = make_engine(pd.DataFrame(lap_rows("A", "T", 2024, "R1", "R", times)))
    assert eng2.calculate_race_features("A", "x", w)["deg_rate"] == 0.15


def test_result_based_features():
    entries = [(5, 3, "Finished")] * 6 + [(5, 3, "Accident")] * 2 + [(4, 3, "+1 Lap")] * 4
    eng = make_engine(results=pd.DataFrame(results_rows("A", entries)))
    w = {"rainfall": False, "track_temp": 35}
    f = eng.calculate_race_features("A", "x", w)
    gains = [g - fi for g, fi, _ in entries]
    assert f["overtake_rate"] == pytest.approx(np.mean(gains))
    assert f["dnf_probability"] == pytest.approx(2 / 12)
    assert f["start_delta"] == pytest.approx(np.clip(np.mean([g * 0.4 for g in gains]), -3, 3))
    assert f["clutch_factor"] == pytest.approx(np.clip(np.mean([g / 5 for g in gains]), -0.5, 0.5))
    # all finishes at/ahead of grid -> defense clamps to 0.95
    assert f["position_hold_rate"] == 0.95


def test_team_trend_improvement():
    # earlier 7 races avg finish 10, last 5 avg finish 5 -> (10-5)/10 = 0.5
    entries = [(10, 10, "Finished")] * 7 + [(10, 5, "Finished")] * 5
    eng = make_engine(results=pd.DataFrame(results_rows("A", entries)))
    w = {"rainfall": False, "track_temp": 35}
    assert eng.calculate_race_features("A", "x", w)["team_trend"] == pytest.approx(0.5)


def test_wet_performance_only_when_wet():
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "R1", "Q", [90.0], rain=False)
        + lap_rows("B", "T", 2024, "R1", "Q", [89.0], rain=False)
        + lap_rows("A", "T", 2024, "R2", "Q", [95.0], rain=True)
        + lap_rows("B", "T", 2024, "R2", "Q", [96.0], rain=True)
    )
    eng = make_engine(laps)
    dry = eng.calculate_race_features("A", "x", {"rainfall": False, "track_temp": 30})
    wet = eng.calculate_race_features("A", "x", {"rainfall": True, "track_temp": 30})
    assert dry["wet_performance"] == 0
    # A: dry gap (90-89)/89*100=1.12%, wet gap 0% -> advantage 1.12 clamp 1.0
    assert wet["wet_performance"] == 1.0


# -- synthetic end-to-end smoke ---------------------------------------------------


def test_full_pipeline_on_synthetic(tmp_path):
    backend = SyntheticBackend(seed=11, n_events=4)
    loader = F1DataLoader(cache_dir=tmp_path, backend=backend)
    eng = F1FeatureEngine(loader)
    eng.load_historical_data([2024])
    assert not eng.laps.empty and not eng.race_results.empty
    drivers = eng.laps["Driver"].unique().tolist()
    qa = eng.quali_feature_arrays(drivers, "Bahrain Grand Prix")
    ra = eng.race_feature_arrays(
        drivers, "Bahrain Grand Prix", {"rainfall": False, "track_temp": 40}
    )
    for k, v in {**qa, **ra}.items():
        assert v.shape == (len(drivers),), k
        assert np.isfinite(v).all(), k
    assert (ra["deg_rate"] >= 0.01).all() and (ra["deg_rate"] <= 0.15).all()
    assert (ra["dnf_probability"] >= 0.01).all() and (ra["dnf_probability"] <= 0.20).all()
    assert (np.abs(qa["form_score"]) <= 1.0).all()


def _assert_equal_value(a, b, ctx):
    if isinstance(a, dict):
        assert set(a) == set(b), ctx
        for d in a:
            _assert_equal_value(a[d], b[d], f"{ctx}[{d}]")
    elif isinstance(a, tuple):
        assert len(a) == len(b), ctx
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_value(x, y, f"{ctx}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=ctx)
    elif isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_names=False)
    elif isinstance(a, pd.Series):
        pd.testing.assert_series_equal(a, b, check_names=False)
    elif a is None or b is None:
        assert a is None and b is None, ctx
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), ctx
    else:
        assert a == b, ctx


def _assert_tables_equal(ta: dict, tb: dict):
    assert set(ta) == set(tb)
    for k in ta:
        _assert_equal_value(ta[k], tb[k], k)


def test_event_partial_memo_matches_fresh(tmp_path):
    """The per-event partial memo must be invisible: an engine that rebuilt
    its archive once per race under the walk-forward pinned clock produces
    the SAME aggregate tables and features as a fresh engine built directly
    at the final clock (bitwise for per-event aggregates; cross-event sums
    identical here because both sides accumulate per event)."""
    from monte_carlo_gp.validate.backtest import _pin, _race_cutoffs, get_races

    backend = SyntheticBackend(seed=3, n_events=6)
    loader = F1DataLoader(cache_dir=tmp_path / "a", backend=backend)
    eng = F1FeatureEngine(loader)
    season = 2024
    cutoffs = _race_cutoffs(loader, season)
    races = get_races(loader, season)
    for i in range(len(races)):
        _pin(loader, cutoffs, i, True)
        eng.load_historical_data([season])
        eng._t()  # populate (and memoize) at every intermediate clock
    assert len(eng._event_parts) > 1  # the memo actually engaged

    loader2 = F1DataLoader(cache_dir=tmp_path / "b", backend=SyntheticBackend(seed=3, n_events=6))
    _pin(loader2, cutoffs, len(races) - 1, True)
    fresh = F1FeatureEngine(loader2)
    fresh.load_historical_data([season])

    _assert_tables_equal(eng._t(), fresh._t())

    drivers = sorted(eng.laps["Driver"].unique().tolist())
    circuit = races[0]
    weather = {"rainfall": True, "track_temp": 30.0}
    for d in drivers:
        assert eng.calculate_quali_features(d, circuit) == pytest.approx(
            fresh.calculate_quali_features(d, circuit)
        )
        assert eng.calculate_race_features(d, circuit, weather) == pytest.approx(
            fresh.calculate_race_features(d, circuit, weather)
        )


def test_direct_assignment_matches_loader_build(tmp_path):
    """Assigning `laps`/`race_results` directly (the A/B harness pattern)
    must produce the same tables as the loader-built archive they came
    from — the derive-from-frame fallback path."""
    backend = SyntheticBackend(seed=5, n_events=4)
    loader = F1DataLoader(cache_dir=tmp_path, backend=backend)
    eng = F1FeatureEngine(loader)
    eng.load_historical_data([2024])

    manual = F1FeatureEngine(data_loader=None)
    manual.laps = eng.laps.copy()
    manual.race_results = eng.race_results.copy()

    _assert_tables_equal(eng._t(), manual._t())


def test_teammate_delta_respects_team_changes():
    """A driver who switches teams between seasons must be compared against
    each season's ACTUAL teammate, not a static roster."""
    laps = pd.DataFrame(
        # 2023: X at TeamA with mate M1; 2024: X at TeamB with mate M2.
        lap_rows("X", "TeamA", 2023, "R1", "Q", [90.0])
        + lap_rows("M1", "TeamA", 2023, "R1", "Q", [91.0])
        + lap_rows("M2", "TeamB", 2023, "R1", "Q", [88.0])
        + lap_rows("X", "TeamB", 2024, "R1", "Q", [90.0])
        + lap_rows("M2", "TeamB", 2024, "R1", "Q", [89.0])
        + lap_rows("M1", "TeamA", 2024, "R1", "Q", [85.0])
    )
    eng = make_engine(laps)
    delta = eng.calculate_quali_features("X", "R1")["teammate_delta"]
    # 2023 vs M1: (91-90)/91*100 = +1.0989; 2024 vs M2: (89-90)/89*100 = -1.1236
    expected = np.mean([(91 - 90) / 91 * 100, (89 - 90) / 89 * 100])
    assert delta == pytest.approx(expected, rel=1e-4)
