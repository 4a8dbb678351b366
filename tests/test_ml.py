"""Gradient-boosted quali model (models/ml.py) — design doc "Approach C".

The reference sketches a LightGBM quali regressor with TimeSeriesSplit CV
(/root/reference/plan.md:1176-1213) but never ships it; our rebuild uses
sklearn's HistGradientBoostingRegressor (same GBDT family). These tests pin
the training-frame chronology (leakage-free by construction), target
semantics, fit/predict contracts, determinism, and the predictor's opt-in
path with Elo fallback.
"""

import numpy as np
import pandas as pd
import pytest

from monte_carlo_gp.models import ml as M
from test_bayesian import DRIVERS, TEAM_OF, _world

# ------------------------------------------------------------ training frame


def _two_event_archive():
    # Event 1 (season 1, circuit c1): A 80.0 (pole), B 80.8 → gap 1.0%
    # Event 2 (season 1, circuit c2): A 91.8, B 90.0 (pole) → A gap 2.0%
    return pd.DataFrame(
        dict(
            Driver=["A", "B", "A", "B"],
            Team=["X", "Y", "X", "Y"],
            circuit=["c1", "c1", "c2", "c2"],
            LapTime=[80.0, 80.8, 91.8, 90.0],
            season=[1, 1, 1, 1],
            session_type=["Q"] * 4,
        )
    )


def test_training_frame_targets_and_chronology():
    data = M.build_training_frame(_two_event_archive())
    assert list(data.meta["circuit"]) == ["c1", "c1", "c2", "c2"]
    np.testing.assert_allclose(data.y, [0.0, 1.0, 2.0, 0.0], atol=1e-6)
    # Event-1 rows have NO history (NaN features, n_events 0).
    first = data.X.iloc[0]
    assert np.isnan(first["career_gap"]) and first["n_events"] == 0.0
    # Event-2 rows see exactly event 1.
    row_a2 = data.X.iloc[2]
    assert row_a2["last_gap"] == pytest.approx(0.0)
    assert row_a2["career_gap"] == pytest.approx(0.0)
    assert row_a2["team_gap"] == pytest.approx(0.0)  # team X pooled = A only
    assert row_a2["n_events"] == 1.0
    row_b2 = data.X.iloc[3]
    assert row_b2["career_gap"] == pytest.approx(1.0)
    # c2 never seen before event 2 → circuit feature missing.
    assert np.isnan(row_a2["circuit_gap"])


def test_training_frame_is_append_only():
    """THE leakage pin: rows for early events are bitwise unchanged when
    later events are appended to the archive."""
    laps, _ = _world()
    events = list(
        laps.groupby("circuit", sort=False).groups
    )  # chronological circuits
    prefix = laps[laps["circuit"].isin(events[:3])]
    full = M.build_training_frame(laps)
    part = M.build_training_frame(prefix)
    n = len(part.y)
    pd.testing.assert_frame_equal(full.X.iloc[:n], part.X)
    np.testing.assert_array_equal(full.y[:n], part.y)


def test_training_frame_raises_on_empty():
    with pytest.raises(ValueError, match="No valid lap times"):
        M.build_training_frame(pd.DataFrame())


# ------------------------------------------------------------ fit / predict


@pytest.fixture(scope="module")
def fitted():
    laps, _ = _world()
    model = M.GBMQualiModel()
    model.fit(laps)
    return laps, model


def test_fit_requires_enough_rows():
    with pytest.raises(ValueError, match="not enough training rows"):
        M.GBMQualiModel().fit(_two_event_archive())


def test_predict_reuses_fit_aggregates(monkeypatch):
    """Prediction features come from the fit's end-of-pass aggregate state
    (QualiTrainingData.agg) — the archive must NOT be re-folded per predict
    (that was O(n_races^2) host work across a walk-forward backtest)."""
    laps, _ = _world()
    laps = laps.copy()
    laps.attrs["_mcgp_loader_token"] = object()
    model = M.GBMQualiModel()
    model.fit(laps)
    before = model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=1)

    def boom(*a, **k):
        raise AssertionError("archive re-folded at predict time")

    monkeypatch.setattr(M, "_event_best_gaps", boom)
    probs = model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=1)
    assert probs == before  # same aggregates, same draws — and no re-fold


def test_predict_distributions(fitted):
    laps, model = fitted
    probs = model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=3)
    arr = np.array([probs[d] for d in DRIVERS])
    assert arr.shape == (len(DRIVERS), len(DRIVERS))
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-9)
    np.testing.assert_allclose(arr.sum(axis=0), 1.0, atol=1e-9)
    assert (arr >= 0).all()


def test_predicted_gaps_track_observed_pace(fitted):
    laps, model = fitted
    mu = model.predict_gaps(laps, DRIVERS, TEAM_OF, "C0")
    fastest = laps.groupby("circuit")["LapTime"].transform("min")
    gap = (laps["LapTime"] - fastest) / fastest * 100.0
    observed = gap.groupby(laps["Driver"]).mean().reindex(DRIVERS).to_numpy()
    corr = np.corrcoef(mu, observed)[0, 1]
    assert corr > 0.9


def test_predict_handles_rookie_and_unseen_circuit(fitted):
    laps, model = fitted
    field = DRIVERS + ["ROOKIE"]
    teams = dict(TEAM_OF, ROOKIE=None)
    probs = model.predict(laps, field, teams, "NEW_CIRCUIT", seed=3)
    arr = np.array([probs[d] for d in field])
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-9)
    assert np.isfinite(arr).all()


def test_predict_is_seed_deterministic(fitted):
    laps, model = fitted
    a = model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=3)
    b = model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=3)
    c = model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=4)
    assert a == b
    assert a != c


def test_fit_cached_per_archive_token():
    laps, _ = _world()
    laps = laps.copy()
    laps.attrs["_mcgp_loader_token"] = object()
    model = M.GBMQualiModel()
    model.fit(laps)
    first = model._models
    model._ensure_fit(laps)
    assert model._models is first  # cached
    rebuilt = laps.copy()
    rebuilt.attrs["_mcgp_loader_token"] = object()
    model._ensure_fit(rebuilt)
    assert model._models is not first  # walk-forward rebuild → refit


# ------------------------------------------------------------ predictor opt-in


def test_predictor_gbm_path_end_to_end(tmp_path):
    from monte_carlo_gp.data.synthetic import SyntheticBackend
    from monte_carlo_gp.models.predictor import F1Predictor

    p = F1Predictor(
        cache_dir=tmp_path,
        backend=SyntheticBackend(seed=2718),
        engine="xla",
        quali_model="gbm",
    )
    plan = p.prepare_weekend(2024, "Bahrain")
    assert isinstance(p._bayes_model, M.GBMQualiModel)  # gbm path actually ran
    arr = np.array([plan.quali_probs[d] for d in plan.drivers])
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-6)
    # Same weekend re-prepared: cached fit + crc32-keyed noise → identical.
    plan2 = p.prepare_weekend(2024, "Bahrain")
    assert plan.quali_probs == plan2.quali_probs


def test_short_race_name_resolves_to_archive_circuit(tmp_path):
    """CLI-style short names ('Bahrain') must hit the same circuit signal
    as the schedule's EventName: the predictor resolves the name before
    the alt model's exact-match circuit lookup (a silent signal drop
    otherwise — the archive stores resolved EventNames)."""
    from monte_carlo_gp.data.synthetic import SyntheticBackend
    from monte_carlo_gp.models.predictor import F1Predictor

    p = F1Predictor(
        cache_dir=tmp_path,
        backend=SyntheticBackend(seed=2718, n_events=4),
        engine="xla",
        quali_model="gbm",
    )
    plan_full = p.prepare_weekend(2024, "Bahrain Grand Prix")
    plan_short = p.prepare_weekend(2024, "Bahrain")
    assert plan_short.quali_probs == plan_full.quali_probs
