"""Walk-forward leakage control.

The backtest must satisfy: the prediction for race k uses ONLY information
from races strictly before k (plus race k's own practice sessions). Two
failure modes are regression-tested here, both real bugs fixed in round 2:

  * Elo look-ahead + double counting: `_build_elo(season)` on an
    already-completed season used to ingest ALL of the season's results
    before race 1 was predicted, and `_apply_actual_elo` then re-applied
    each race's results (the reference avoided double counting only because
    its updates silently no-op — SURVEY.md §3.2 ⚠).
  * Feature look-ahead: `load_historical_data` used to ingest the full
    current season's laps/results once before race 1.

The fix pins the data loader's clock (`loader.set_now`) to just before each
race's event date during backtests (validate/backtest.py `_pin`).
"""

import numpy as np
import pytest

from monte_carlo_gp.data.synthetic import SyntheticBackend
from monte_carlo_gp.models.predictor import F1Predictor
from monte_carlo_gp.validate.backtest import backtest_model

N_EVENTS = 3
SEASON = 2024


def _make_spy(tmp_path, elo_snapshots, archive_snapshots):
    class SpyPredictor(F1Predictor):
        def prepare_weekend(self, *args, **kwargs):
            plan = super().prepare_weekend(*args, **kwargs)
            elo_snapshots.append(self.elo_system.state_dict())
            laps = self.feature_engine.laps
            if laps.empty:
                archive_snapshots.append(set())
            else:
                archive_snapshots.append(
                    set(
                        map(
                            tuple,
                            laps[["season", "circuit"]].drop_duplicates().to_numpy(),
                        )
                    )
                )
            return plan

    def factory():
        return SpyPredictor(
            cache_dir=tmp_path, backend=SyntheticBackend(seed=5, n_events=N_EVENTS)
        )

    return factory


def _ratings_map(state):
    return {n: tuple(np.round(r, 4)) for n, r in zip(state["names"], state["ratings"])}


@pytest.mark.slow
def test_backtest_elo_walk_forward_no_leak_no_double_count(tmp_path):
    elo_snaps, archive_snaps = [], []
    backtest_model(
        _make_spy(tmp_path, elo_snaps, archive_snaps),
        [SEASON],
        seed=11,
        n_simulations=64,
        verbose=False,
    )
    assert len(elo_snaps) == N_EVENTS

    # Control: what ratings SHOULD be at each race under strict walk-forward:
    # previous season fully built, then only races < k applied as actuals.
    from monte_carlo_gp.validate.backtest import (
        _pin,
        _race_cutoffs,
        get_actual_results,
        get_races,
    )

    control = F1Predictor(
        cache_dir=tmp_path, backend=SyntheticBackend(seed=5, n_events=N_EVENTS)
    )
    loader = control.data_loader
    races = get_races(loader, SEASON)
    cutoffs = _race_cutoffs(loader, SEASON)
    actuals = [get_actual_results(loader, SEASON, r) for r in races]
    _pin(loader, cutoffs, 0, True)
    control._build_elo(SEASON)

    for k in range(N_EVENTS):
        expected = _ratings_map(control.elo_system.state_dict())
        got = _ratings_map(elo_snaps[k])
        assert got == expected, (
            f"race {k}: Elo at prediction time diverges from strict "
            f"walk-forward (leak or double-counted events)"
        )
        # Mirror _apply_actual_elo's explicit current-season recency
        # weight (race-index ramp) for the applied actuals.
        control.elo_system.set_recency_weight(0, k, N_EVENTS)
        control.elo_system.update_quali_ratings(actuals[k]["quali_results"])
        control.elo_system.update_race_ratings(actuals[k]["race_results"])


@pytest.mark.slow
def test_backtest_feature_archive_no_leak(tmp_path):
    elo_snaps, archive_snaps = [], []
    backtest_model(
        _make_spy(tmp_path, elo_snaps, archive_snaps),
        [SEASON],
        seed=11,
        n_simulations=64,
        verbose=False,
    )
    assert len(archive_snaps) == N_EVENTS
    from monte_carlo_gp.validate.backtest import get_races

    control = F1Predictor(
        cache_dir=tmp_path, backend=SyntheticBackend(seed=5, n_events=N_EVENTS)
    )
    races = get_races(control.data_loader, SEASON)
    for k in range(N_EVENTS):
        current = {c for (s, c) in archive_snaps[k] if s == SEASON}
        assert current == set(races[:k]), (
            f"race {k}: feature archive sees current-season races {current}, "
            f"expected exactly {set(races[:k])}"
        )
        # previous season fully present
        assert {c for (s, c) in archive_snaps[k] if s == SEASON - 1} == set(races)


def test_dateless_events_cannot_leak_under_pinned_clock(tmp_path):
    """A NaT EventDate must NOT silently unpin the clock or slip past it:
    (a) cutoffs back-fill from the nearest earlier cutoff (dateless opener:
    the season's Jan 1), and (b) once the clock is pinned, `past_events`
    EXCLUDES dateless events entirely — an included one would leak its
    results into every race's Elo/feature inputs."""
    import pandas as pd

    from monte_carlo_gp.data.loader import F1DataLoader
    from monte_carlo_gp.validate.backtest import _race_cutoffs

    class Sched:
        def __init__(self, events):
            self._events = events

        def get_schedule(self, season):
            return self._events

        def load_laps(self, *a):
            return None

        def load_results(self, *a):
            return None

        def load_weather(self, *a):
            return None

    d1 = pd.Timestamp("2024-03-01", tz="UTC")
    events = [
        {"EventName": "A", "EventFormat": "conventional", "EventDate": pd.NaT},
        {"EventName": "B", "EventFormat": "conventional", "EventDate": d1},
        {"EventName": "C", "EventFormat": "conventional", "EventDate": pd.NaT},
    ]
    loader = F1DataLoader(cache_dir=tmp_path, backend=Sched(events))
    cutoffs = _race_cutoffs(loader, 2024)
    assert cutoffs[0] == pd.Timestamp("2024-01-01", tz="UTC")
    assert cutoffs[1] == d1 - pd.Timedelta(seconds=1)
    assert cutoffs[2] == cutoffs[1]  # back-fill, never forward

    # normal (wall-clock) operation keeps dateless events — reference parity
    assert [e["EventName"] for e in loader.past_events(2024)] == ["A", "B", "C"]
    # pinned clock: dateless events are excluded from everything derived
    # from past_events (Elo season builds, feature archives)
    loader.set_now(cutoffs[1])
    assert [e["EventName"] for e in loader.past_events(2024)] == []
    loader.set_now(d1 + pd.Timedelta(days=1))
    assert [e["EventName"] for e in loader.past_events(2024)] == ["B"]


@pytest.mark.slow
def test_pin_clock_false_reproduces_leaky_reference_behavior(tmp_path):
    """pin_clock=False must differ from the fixed default (proves the fix
    does something) and must load the full season up front."""
    elo_snaps, archive_snaps = [], []
    backtest_model(
        _make_spy(tmp_path, elo_snaps, archive_snaps),
        [SEASON],
        seed=11,
        n_simulations=64,
        pin_clock=False,
        verbose=False,
    )
    # leaky mode: all 3 races' laps are in the archive before race 1
    current = {c for (s, c) in archive_snaps[0] if s == SEASON}
    assert len(current) == N_EVENTS
