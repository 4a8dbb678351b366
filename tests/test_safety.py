"""Fallback-prediction wrapper + rookie teammate-prior initialization.

The reference's design doc specifies both (plan.md:2674-2783) but the
shipped reference implements neither: the empty-practice path just raises
(reference predictor.py:188-190) and rookies start at the flat initial
rating (reference elo.py:7-11). These tests pin the rebuild's
implementation of that roadmap (models/safety.py, F1EloSystem.initialize_rookie).
"""

import numpy as np
import pytest

from monte_carlo_gp import config as cfg
from monte_carlo_gp.data.synthetic import SyntheticBackend
from monte_carlo_gp.models.elo import F1EloSystem
from monte_carlo_gp.models.predictor import F1Predictor
from monte_carlo_gp.models.safety import (
    InsufficientDataError,
    PredictionError,
    generate_fallback_predictions,
    safe_predict,
)

# ---------------------------------------------------------------- fallback


def test_fallback_shape_default_roster():
    r = generate_fallback_predictions(2025, "Monaco")
    drivers = list(cfg.DRIVER_TEAMS.keys())
    n = len(drivers)
    assert sorted(r["pole_probabilities"]) == sorted(drivers)
    assert abs(sum(r["win_probabilities"].values()) - 1.0) < 1e-9
    for d in drivers:
        assert r["pole_probabilities"][d] == pytest.approx(1.0 / n)
        assert r["podium_probabilities"][d] == pytest.approx(min(3.0 / n, 1.0))
        dist = r["full_distributions"][d]
        assert sorted(dist) == list(range(1, n + 1))
        assert abs(sum(dist.values()) - 1.0) < 1e-9
    assert r["fallback"] is True
    assert r["confidence"] == "none"
    assert r["grid_is_actual"] is False
    assert r["prediction_point"] == "fp2"
    assert r["weather"]["rainfall"] is False


def test_fallback_explicit_and_empty_fields():
    r = generate_fallback_predictions(2025, "Monaco", "fp3", drivers=["A", "B"])
    assert r["prediction_point"] == "fp3"
    assert r["win_probabilities"] == {"A": 0.5, "B": 0.5}
    assert r["podium_probabilities"] == {"A": 1.0, "B": 1.0}  # min(3/2, 1)
    empty = generate_fallback_predictions(2025, "Monaco", drivers=[])
    assert empty["pole_probabilities"] == {}
    assert empty["full_distributions"] == {}
    assert empty["fallback"] is True and empty["confidence"] == "none"


def test_exception_hierarchy():
    # Also a ValueError: pre-existing callers catching the original
    # "No practice data" ValueError keep working.
    assert issubclass(InsufficientDataError, PredictionError)
    assert issubclass(InsufficientDataError, ValueError)


class _StubPredictor:
    def __init__(self, exc=None, result=None):
        self.exc = exc
        self.result = result
        self.calls = []

    def predict_weekend(self, season, race, **kw):
        self.calls.append((season, race, kw))
        if self.exc is not None:
            raise self.exc
        return self.result


def test_safe_predict_passthrough_and_kwargs():
    stub = _StubPredictor(result={"ok": True})
    out = safe_predict(stub, 2025, "Monaco", prediction_point="quali",
                       actual_grid={"VER": 1}, n_simulations=123, seed=7)
    assert out == {"ok": True}
    (_, _, kw), = stub.calls
    assert kw["n_simulations"] == 123 and kw["seed"] == 7
    assert kw["actual_grid"] == {"VER": 1}


def test_safe_predict_insufficient_data_degrades_to_fallback():
    stub = _StubPredictor(exc=InsufficientDataError("no FP data"))
    out = safe_predict(stub, 2025, "Monaco", prediction_point="fp1")
    assert out is not None and out["fallback"] is True
    assert out["prediction_point"] == "fp1"


def test_safe_predict_other_errors_return_none():
    stub = _StubPredictor(exc=RuntimeError("boom"))
    assert safe_predict(stub, 2025, "Monaco") is None


def test_predictor_raises_insufficient_data(tmp_path, monkeypatch):
    import pandas as pd

    predictor = F1Predictor(
        cache_dir=tmp_path, backend=SyntheticBackend(seed=3, n_events=2)
    )
    monkeypatch.setattr(
        predictor.data_loader, "load_session",
        lambda *a, **k: pd.DataFrame(),
    )
    with pytest.raises(InsufficientDataError):
        predictor.prepare_weekend(2024, "Bahrain")
    # ... and safe_predict turns exactly that into the fallback dict.
    out = safe_predict(predictor, 2024, "Bahrain")
    assert out["fallback"] is True


# ------------------------------------------------------------- rookie prior


def test_rookie_prior_is_teammate_mean_minus_50():
    elo = F1EloSystem()
    # Two rated teammates at team T1 (values: lower is better).
    elo.update_quali_ratings([("AAA", 88.0), ("BBB", 89.0), ("CCC", 90.0)])
    teams = {"AAA": "T1", "BBB": "T1", "CCC": "T2", "NEW": "T1"}
    expected = (elo.get_rating("AAA") + elo.get_rating("BBB")) / 2.0 - 50.0
    rating = elo.initialize_rookie("NEW", "T1", driver_teams=teams)
    assert rating == pytest.approx(expected)
    assert elo.get_rating("NEW", "quali") == pytest.approx(expected)
    assert elo.get_rating("NEW", "race") == pytest.approx(expected)
    assert elo.has_rating("NEW")


def test_rookie_prior_unknown_teammates_count_at_initial():
    # Teammate never rated -> contributes the 1500 initial rating, matching
    # the spec's ratings.get(t, {}).get('quali', 1500) (plan.md:2770-2773).
    elo = F1EloSystem()
    elo.update_quali_ratings([("AAA", 88.0), ("XXX", 91.0)])
    teams = {"AAA": "T1", "GHOST": "T1", "NEW": "T1", "XXX": "T2"}
    expected = (elo.get_rating("AAA") + 1500.0) / 2.0 - 50.0
    assert elo.initialize_rookie("NEW", "T1", teams) == pytest.approx(expected)


def test_rookie_prior_new_team_defaults_1350():
    elo = F1EloSystem()
    assert elo.initialize_rookie("NEW", "Brand New Team", {"NEW": "Brand New Team"}) == 1350.0
    assert elo.has_rating("NEW")


def test_rookie_prior_unknown_team_stays_at_initial():
    # No team info is no reason to demote below the flat default: the driver
    # is left at the initial rating and NOT interned (so a later weekend
    # with team data can still seed them properly).
    elo = F1EloSystem()
    assert elo.initialize_rookie("SOLO", None, {}) == 1500.0
    assert not elo.has_rating("SOLO")


def test_rookie_prior_batch_is_order_independent():
    # Two unrated teammates must BOTH draw the other at the initial rating:
    # the batch API snapshots priors before seeding anyone.
    for order in (("NEW1", "NEW2"), ("NEW2", "NEW1")):
        elo = F1EloSystem()
        teams = {"NEW1": "T1", "NEW2": "T1"}
        seeded = elo.initialize_rookies({d: "T1" for d in order}, teams)
        assert seeded["NEW1"] == seeded["NEW2"] == 1450.0


def test_rookie_prior_sees_pending_events():
    # Buffered (unflushed) events must be applied before the prior is read.
    elo = F1EloSystem()
    elo.update_quali_ratings([("AAA", 88.0), ("BBB", 92.0)])
    teams = {"AAA": "T1", "NEW": "T1", "BBB": "T2"}
    assert elo._pending  # the event is still buffered at this point
    rating = elo.initialize_rookie("NEW", "T1", teams)
    assert rating != 1500.0 - 50.0  # AAA's win moved it off the initial rating
    assert rating == pytest.approx(elo.get_rating("AAA") - 50.0)


def test_predictor_rookie_hook(tmp_path):
    """prepare_weekend with rookie_prior=True seeds any unrated driver in
    the weekend field from the teammate prior."""
    predictor = F1Predictor(
        cache_dir=tmp_path,
        backend=SyntheticBackend(seed=5, n_events=3),
        rookie_prior=True,
    )
    plan = predictor.prepare_weekend(2024, "Bahrain")
    # Synthetic world: every fielded driver has history, so the hook is a
    # no-op here; force a rookie by dropping one driver's rating row and
    # re-preparing (Elo/features are cached, so _build_elo won't re-add it).
    victim = plan.drivers[0]
    team = cfg.DRIVER_TEAMS.get(victim)
    # Drop only the interning entry (NOT the _names row — that would shift
    # every later driver's index): re-interning appends a fresh row, so no
    # existing rating is disturbed.
    predictor.elo_system._ids.pop(victim)
    assert not predictor.elo_system.has_rating(victim)
    predictor.prepare_weekend(2024, "Bahrain")
    assert predictor.elo_system.has_rating(victim)
    teammates = [
        d for d, t in cfg.DRIVER_TEAMS.items() if t == team and d != victim
    ]
    if teammates:
        expected = np.mean(
            [predictor.elo_system.get_rating(t) for t in teammates]
        ) - 50.0
    else:
        expected = 1350.0
    assert predictor.elo_system.get_rating(victim) == pytest.approx(expected)
