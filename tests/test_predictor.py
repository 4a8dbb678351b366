"""Predictor orchestration: end-to-end on the synthetic backend plus unit
tests of the practice-data extraction and penalty logic
(reference predictor.py semantics)."""

import numpy as np
import pandas as pd
import pytest

from monte_carlo_gp.data.synthetic import SyntheticBackend
from monte_carlo_gp.models.predictor import F1Predictor


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    return F1Predictor(
        cache_dir=tmp_path_factory.mktemp("cache"),
        backend=SyntheticBackend(seed=5, n_events=3),
    )


@pytest.fixture(scope="module")
def weekend(predictor):
    return predictor.predict_weekend(
        2024, "Bahrain", n_simulations=2000, seed=11
    )


def test_result_contract(weekend):
    r = weekend
    for key in (
        "pole_probabilities", "win_probabilities", "podium_probabilities",
        "full_distributions", "weather", "prediction_point", "confidence",
        "grid_is_actual",
    ):
        assert key in r
    assert r["confidence"] == "moderate" and r["prediction_point"] == "fp2"
    assert not r["grid_is_actual"]
    assert len(r["win_probabilities"]) == 20
    assert abs(sum(r["win_probabilities"].values()) - 1.0) < 1e-3
    # pole probs are per-driver slot-0 marginals of independently normalized
    # position distributions — they need NOT sum to 1 (reference semantics,
    # predictor.py:447-451); they just have to be valid probabilities.
    assert all(0.0 <= p <= 1.0 for p in r["pole_probabilities"].values())
    for d, dist in r["full_distributions"].items():
        assert abs(sum(dist.values()) - 1.0) < 1e-3
        assert all(1 <= p <= 20 for p in dist)
    # podium prob >= win prob per driver
    for d in r["win_probabilities"]:
        assert r["podium_probabilities"][d] >= r["win_probabilities"][d] - 1e-9


def test_seed_determinism(predictor, weekend):
    again = predictor.predict_weekend(2024, "Bahrain", n_simulations=2000, seed=11)
    assert again["win_probabilities"] == weekend["win_probabilities"]
    other = predictor.predict_weekend(2024, "Bahrain", n_simulations=2000, seed=12)
    assert other["win_probabilities"] != weekend["win_probabilities"]


def test_simulations_honored(predictor):
    """--simulations actually drives the engine (the reference parses and
    ignores it, SURVEY.md preamble). With few sims, probabilities are coarse
    multiples of 1/n."""
    r = predictor.predict_weekend(2024, "Bahrain", n_simulations=128, seed=3)
    vals = np.array(list(r["win_probabilities"].values()))
    steps = vals * 128
    np.testing.assert_allclose(steps, np.round(steps), atol=1e-4)


def test_actual_grid_path(predictor):
    grid = {d: i + 1 for i, d in enumerate(predictor.elo_system.names[:20])}
    # build from the actual driver list of the synthetic world
    backend = predictor.data_loader.backend
    drivers = backend.drivers
    grid = {d: i + 1 for i, d in enumerate(drivers)}
    r = predictor.predict_weekend(
        2024, "Bahrain", prediction_point="quali", actual_grid=grid,
        n_simulations=500, seed=1,
    )
    assert r["grid_is_actual"] and r["confidence"] == "high"
    # pole probabilities collapse to the actual grid: P1 driver has 1.0
    assert r["pole_probabilities"][drivers[0]] == 1.0
    assert r["pole_probabilities"][drivers[1]] == 0.0


def test_wet_weekend(predictor):
    r = predictor.predict_weekend(2024, "Australia", n_simulations=500, seed=2)
    assert not r["weather"]["rainfall"]


def test_unknown_race_uses_default_circuit(predictor):
    with pytest.raises(ValueError):
        predictor.predict_weekend(2024, "Atlantis", n_simulations=100)


def test_apply_grid_penalties():
    p = F1Predictor.__new__(F1Predictor)  # no data needed
    quali = {"A": 1, "B": 2, "C": 3, "D": 4}
    out = p.apply_grid_penalties(quali, {"A": 5})
    # A 1+5=6 -> last; others shift up
    assert out == {"B": 1, "C": 2, "D": 3, "A": 4}
    out = p.apply_grid_penalties(quali, {"B": "gearbox"})  # +5 -> 7
    assert out == {"A": 1, "C": 2, "D": 3, "B": 4}
    # tie: B penalized to 3 ties with C's 3; original quali position wins
    out = p.apply_grid_penalties(quali, {"B": 1})
    assert out == {"A": 1, "B": 2, "C": 3, "D": 4}


def test_adjust_for_penalties_shifts_distribution():
    p = F1Predictor.__new__(F1Predictor)
    probs = {"A": [0.5, 0.3, 0.2, 0.0], "B": [0.25] * 4}
    out = p._adjust_for_penalties(probs, {"A": 2})
    assert out["A"] == [0.0, 0.0, 0.5, 0.5]  # shifted, tail accumulates
    assert out["B"] == [0.25] * 4
    out = p._adjust_for_penalties(probs, {"A": "full_pu"})  # 20 >= n
    assert out["A"] == [0.0, 0.0, 0.0, 1.0]


def test_extract_race_pace_rules():
    fp = pd.DataFrame(
        {
            "Driver": ["A"] * 5 + ["B"] * 2 + ["C"] * 3,
            "LapTime": [90.0, 85.0, 86.0, 87.0, 95.0, 88.0, 89.0, np.nan, np.nan, np.nan],
            "LapNumber": [1, 2, 3, 4, 5, 1, 2, 1, 2, 3],
            "PitInTime": [np.nan] * 10,
            "PitOutTime": [np.nan] * 10,
        }
    )
    pace = F1Predictor._extract_race_pace(fp)
    # A: middle laps (85,86,87) -> median 86; B: <3 laps -> 25th pct of (88,89)
    assert pace["A"] == pytest.approx(86.0)
    assert pace["B"] == pytest.approx(np.quantile([88.0, 89.0], 0.25))
    # C: no valid -> field median of {86, 88.25}
    assert pace["C"] == pytest.approx(np.median([86.0, pace["B"]]))


def test_extract_race_pace_filters_pit_laps():
    fp = pd.DataFrame(
        {
            "Driver": ["A"] * 6,
            "LapTime": [90.0, 90.0, 90.0, 90.0, 120.0, 120.0],
            "LapNumber": [1, 2, 3, 4, 5, 6],
            "PitInTime": [np.nan] * 4 + [1.0, np.nan],
            "PitOutTime": [np.nan] * 5 + [1.0],
        }
    )
    pace = F1Predictor._extract_race_pace(fp)
    assert pace["A"] == pytest.approx(90.0)


def test_extract_tire_deg_rules():
    rising = [90.0 + 0.06 * i for i in range(10)]
    falling = [90.0 - 0.1 * i for i in range(10)]
    fp = pd.DataFrame(
        {
            "Driver": ["A"] * 10 + ["B"] * 10 + ["C"] * 3,
            "LapTime": rising + falling + [90.0] * 3,
            "LapNumber": list(range(10)) * 2 + [0, 1, 2],
        }
    )
    deg = F1Predictor._extract_tire_deg(fp)
    assert deg["A"] == pytest.approx(0.06, abs=1e-6)
    assert deg["B"] == 0.05  # warming up -> default
    assert deg["C"] == 0.05  # too few laps


def test_extract_compound_deltas():
    fp = pd.DataFrame(
        {
            "Driver": ["A"] * 12,
            "Compound": ["SOFT"] * 4 + ["MEDIUM"] * 4 + ["HARD"] * 4,
            "LapTime": [89.0, 89.1, 89.2, 98.0]  # 98 is >107% of 89 -> dropped
            + [90.0, 90.1, 90.2, 90.3]
            + [91.0, 91.1, 91.2, 91.3],
        }
    )
    out = F1Predictor._extract_tire_compound_deltas(fp)
    assert out["SOFT"]["pace_delta"] == pytest.approx(89.1 - 90.15, abs=0.01)
    assert out["MEDIUM"]["pace_delta"] == 0.0
    assert out["HARD"]["pace_delta"] == pytest.approx(91.15 - 90.15, abs=0.01)
    # non-pace fields keep defaults
    assert out["SOFT"]["optimal_laps"] == 15


@pytest.mark.slow
def test_sprint_weekend_chained_predictions(tmp_path_factory):
    """BASELINE configs[2]: chained predictions through a sprint weekend —
    fp1 -> sprint (grid from sprint qualifying) -> race (grid from quali),
    with confidence tightening at each step."""
    backend = SyntheticBackend(seed=9, n_events=5)  # includes China (sprint)
    p = F1Predictor(cache_dir=tmp_path_factory.mktemp("sprintc"), backend=backend)
    race = "China"

    early = p.predict_weekend(2024, race, prediction_point="fp1",
                              n_simulations=512, seed=1)
    assert early["confidence"] == "low"

    sq = backend.load_results(2024, "China Grand Prix", "SQ")
    sq_grid = dict(zip(sq["Abbreviation"], sq["Position"].astype(int)))
    mid = p.predict_weekend(2024, race, prediction_point="sprint",
                            actual_grid=sq_grid, n_simulations=512, seed=1)
    assert mid["confidence"] == "high" and mid["grid_is_actual"]

    q = backend.load_results(2024, "China Grand Prix", "Q")
    q_grid = dict(zip(q["Abbreviation"], q["Position"].astype(int)))
    final = p.predict_weekend(2024, race, prediction_point="quali",
                              actual_grid=q_grid, n_simulations=512, seed=1)
    assert final["grid_is_actual"]
    # grid known exactly -> pole probabilities collapse to the actual order
    pole_driver = [d for d, g in q_grid.items() if g == 1][0]
    assert final["pole_probabilities"][pole_driver] == 1.0
    # all three produce valid race distributions
    for r in (early, mid, final):
        assert abs(sum(r["win_probabilities"].values()) - 1.0) < 1e-3


@pytest.mark.parametrize("engine", ["auto", "xla"])
def test_engine_selection(tmp_path_factory, engine):
    """Both engine names build a predictor on the XLA lap-scan engine, and
    simulate_plan runs the requested sim count exactly."""
    backend = SyntheticBackend(seed=9, n_events=2)
    p = F1Predictor(cache_dir=tmp_path_factory.mktemp("eng"), backend=backend,
                    engine=engine)
    plan = p.prepare_weekend(2024, "Bahrain")
    probs = p.simulate_plan(plan, 100, seed=1)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    assert p.last_effective_sims == 100


@pytest.mark.parametrize("engine", ["pallas", "cuda"])
def test_engine_selection_refuses_unknown(tmp_path_factory, engine):
    with pytest.raises(ValueError, match="unknown engine"):
        F1Predictor(cache_dir=tmp_path_factory.mktemp("eng2"),
                    backend=SyntheticBackend(seed=9, n_events=2), engine=engine)


# ------------------------------------------------- weekend team assignment


def test_teams_from_fp_prefers_frame_vocabulary():
    """The weekend driver->team map comes from the session frame's own Team
    column (FastF1 vocabulary, historical rosters), NOT the static 2025
    cfg.DRIVER_TEAMS table — the static map is only the per-row fallback
    when Team is missing (regression for the alt-quali/rookie-prior team
    signal: a real-data archive's 'Red Bull Racing' must not be replaced by
    the config's 'Red Bull')."""
    fp = pd.DataFrame(
        {
            "Driver": ["VER", "VER", "HAM", "GHO"],
            "Team": ["Red Bull Racing", "Red Bull Racing",
                     "Scuderia Ferrari", None],
        }
    )
    teams = F1Predictor._teams_from_fp(fp, ["VER", "HAM", "GHO"])
    assert teams["VER"] == "Red Bull Racing"      # frame wins over cfg
    assert teams["HAM"] == "Scuderia Ferrari"     # 2024 Mercedes? frame wins
    from monte_carlo_gp import config as cfg
    assert teams["GHO"] == cfg.DRIVER_TEAMS.get("GHO")  # NaN row -> fallback


def test_prepare_weekend_feeds_frame_teams_to_alt_quali(tmp_path_factory):
    """prepare_weekend passes the frame-derived map into the alt quali
    models (they key team effects on it)."""
    backend = SyntheticBackend(seed=5, n_events=3)
    p = F1Predictor(
        cache_dir=tmp_path_factory.mktemp("teams"),
        backend=backend,
        quali_model="gbm",
    )
    captured = {}

    def fake_alt(drivers, race, season, driver_teams=None):
        captured["teams"] = driver_teams
        return None  # fall back to the Elo path; we only test the plumbing

    p._predict_quali_alt = fake_alt
    plan = p.prepare_weekend(2024, "Bahrain")
    fp = p.data_loader.load_session(2024, "Bahrain", "FP2")
    expected = F1Predictor._teams_from_fp(fp, plan.drivers)
    assert captured["teams"] == expected
    assert all(v is not None for v in expected.values())
