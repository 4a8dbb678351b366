"""Contract tests for the FastF1 network backend with a stubbed `fastf1`.

fastf1 is not installed in CI, so `FastF1Backend`
(monte_carlo_gp/data/loader.py) — the production data path mapping the
reference's `F1DataLoader` (reference data_loader.py:15-33, 132-156) — never
executes in any other test. These tests stub the `fastf1` module with fake
sessions returning Timedelta-typed frames (the real library's dtypes) and
assert the backend emits the normalized schema exactly:

  * LapTime / Sector{1,2,3}Time: Timedelta -> float seconds;
  * PitInTime / PitOutTime: notna -> 1.0, NaT -> NaN (downstream code only
    ever tests isna(), reference data_loader.py:97 / predictor.py:560);
  * missing columns -> NaN-filled, full _LAP_COLUMNS schema always present;
  * weather: NaN-safe column means with defaults, rainfall = any();
  * schedule: EventName/Location/EventFormat/EventDate/RoundNumber;
  * session-load failure -> None (graceful degradation,
    reference data_loader.py:31-33);
  * offline mode never touches the network backend.
"""

from __future__ import annotations

import sys
import types

import numpy as np
import pandas as pd
import pytest

from monte_carlo_gp.data.loader import _LAP_COLUMNS, F1DataLoader


class FakeSession:
    def __init__(self, laps=None, results=None, weather=None, fail=False):
        self._laps = laps
        self._results = results
        self._weather = weather
        self._fail = fail
        self.load_calls = []

    def load(self, **kwargs):
        self.load_calls.append(kwargs)
        if self._fail:
            raise RuntimeError("simulated fastf1 network failure")

    @property
    def laps(self):
        return self._laps

    @property
    def results(self):
        return self._results

    @property
    def weather_data(self):
        return self._weather


def make_fake_fastf1(sessions: dict, schedule: pd.DataFrame | None = None):
    """A stub module shaped like fastf1: Cache.enable_cache, get_session,
    get_event_schedule."""
    fake = types.ModuleType("fastf1")
    fake.cache_dirs = []

    class _Cache:
        @staticmethod
        def enable_cache(path):
            fake.cache_dirs.append(path)

    fake.Cache = _Cache
    fake.session_requests = []

    def get_session(season, event, session):
        fake.session_requests.append((season, event, session))
        try:
            return sessions[(season, event, session)]
        except KeyError:
            raise ValueError(f"no such session {(season, event, session)}")

    fake.get_session = get_session
    fake.get_event_schedule = lambda season: schedule
    return fake


def td(seconds):
    return pd.Timedelta(seconds=seconds)


@pytest.fixture()
def backend_for(monkeypatch, tmp_path):
    """Factory: install a fastf1 stub and construct a FastF1Backend on it."""

    def build(sessions, schedule=None):
        fake = make_fake_fastf1(sessions, schedule)
        monkeypatch.setitem(sys.modules, "fastf1", fake)
        from monte_carlo_gp.data.loader import FastF1Backend

        backend = FastF1Backend(str(tmp_path / "ff1"))
        assert fake.cache_dirs == [str(tmp_path / "ff1")]
        return backend, fake

    return build


# -- laps ---------------------------------------------------------------------


def laps_frame():
    """A realistic fastf1 .laps frame: Timedelta time columns, NaT pit
    columns except in/out laps, one missing column (Position)."""
    return pd.DataFrame(
        {
            "Driver": ["VER", "VER", "HAM"],
            "Team": ["Red Bull Racing", "Red Bull Racing", "Mercedes"],
            "LapTime": [td(92.357), td(91.001), pd.NaT],
            "LapNumber": [1.0, 2.0, 1.0],
            "Sector1Time": [td(28.5), td(28.1), td(29.0)],
            "Sector2Time": [td(35.0), td(34.7), pd.NaT],
            "Sector3Time": [td(28.857), td(28.201), td(29.5)],
            "Compound": ["SOFT", "SOFT", "MEDIUM"],
            "IsAccurate": [True, True, False],
            "PitInTime": [pd.NaT, td(5400.2), pd.NaT],
            "PitOutTime": [td(100.0), pd.NaT, pd.NaT],
            "Deleted": [False, False, True],
            "TrackTemp": [41.2, 41.5, 40.9],
            "Rainfall": [False, False, False],
        }
    )


def test_load_laps_normalizes_schema(backend_for):
    backend, fake = backend_for({(2024, "Bahrain", "FP2"): FakeSession(laps=laps_frame())})
    out = backend.load_laps(2024, "Bahrain", "FP2")

    assert list(out.columns) == _LAP_COLUMNS
    # Timedelta -> float seconds, NaT -> NaN.
    assert out["LapTime"].tolist()[:2] == [92.357, 91.001]
    assert np.isnan(out["LapTime"].iloc[2])
    assert out["Sector1Time"].dtype == np.float64 or np.issubdtype(
        out["Sector1Time"].dtype, np.floating
    )
    assert out["Sector3Time"].iloc[1] == 28.201
    assert np.isnan(out["Sector2Time"].iloc[2])
    # Pit columns: presence flag 1.0 / NaN — the isna() contract downstream.
    assert np.isnan(out["PitInTime"].iloc[0]) and out["PitInTime"].iloc[1] == 1.0
    assert out["PitOutTime"].iloc[0] == 1.0 and np.isnan(out["PitOutTime"].iloc[1])
    # A column fastf1 didn't provide is NaN-filled, not absent.
    assert out["Position"].isna().all()
    # Non-time columns ride through unchanged.
    assert out["Driver"].tolist() == ["VER", "VER", "HAM"]
    assert out["Compound"].tolist() == ["SOFT", "SOFT", "MEDIUM"]
    assert out["IsAccurate"].tolist() == [True, True, False]
    assert out["Deleted"].tolist() == [False, False, True]
    assert out["TrackTemp"].tolist() == [41.2, 41.5, 40.9]


def test_load_laps_feeds_quali_extraction(backend_for):
    """End-to-end: the normalized frame drives extract_quali_results the
    same way the reference's _extract_quali_results consumes raw fastf1
    laps (reference data_loader.py:86-114)."""
    from monte_carlo_gp.data.loader import extract_quali_results

    backend, _ = backend_for({(2024, "Bahrain", "Q"): FakeSession(laps=laps_frame())})
    out = backend.load_laps(2024, "Bahrain", "Q")
    res = extract_quali_results(out)
    # HAM's only lap is NaT/inaccurate; VER's best accurate lap is 91.001.
    assert res == [("VER", 91.001)]


def test_load_laps_failure_returns_none(backend_for, capsys):
    backend, _ = backend_for(
        {(2024, "Bahrain", "FP1"): FakeSession(laps=laps_frame(), fail=True)}
    )
    assert backend.load_laps(2024, "Bahrain", "FP1") is None
    assert "could not load" in capsys.readouterr().out
    # Unknown session (get_session itself raises) degrades the same way.
    assert backend.load_laps(2024, "Nowhere", "FP1") is None


def test_load_laps_empty_returns_none(backend_for):
    backend, _ = backend_for(
        {(2024, "Bahrain", "FP3"): FakeSession(laps=pd.DataFrame())}
    )
    assert backend.load_laps(2024, "Bahrain", "FP3") is None


# -- results ------------------------------------------------------------------


def test_load_results_selects_reference_columns(backend_for):
    res = pd.DataFrame(
        {
            "Abbreviation": ["VER", "HAM", "SAI"],
            "GridPosition": [1.0, 3.0, 2.0],
            "Position": [1.0, 2.0, np.nan],
            "Status": ["Finished", "Finished", "Engine"],
            "Points": [25.0, 18.0, 0.0],  # extra fastf1 column, dropped
        }
    )
    backend, _ = backend_for({(2024, "Bahrain", "R"): FakeSession(results=res)})
    out = backend.load_results(2024, "Bahrain", "R")
    assert list(out.columns) == ["Abbreviation", "GridPosition", "Position", "Status"]
    assert out["Abbreviation"].tolist() == ["VER", "HAM", "SAI"]
    assert out["Status"].tolist() == ["Finished", "Finished", "Engine"]
    assert np.isnan(out["Position"].iloc[2])


def test_load_results_failure_and_empty(backend_for):
    backend, _ = backend_for(
        {
            (2024, "A", "R"): FakeSession(results=pd.DataFrame(), fail=False),
            (2024, "B", "R"): FakeSession(results=None, fail=True),
        }
    )
    assert backend.load_results(2024, "A", "R") is None
    assert backend.load_results(2024, "B", "R") is None


# -- weather ------------------------------------------------------------------


def test_load_weather_aggregates_with_nan_defaults(backend_for):
    w = pd.DataFrame(
        {
            "AirTemp": [24.0, 26.0, np.nan],
            "TrackTemp": [np.nan, np.nan, np.nan],  # all-NaN -> default 35
            "Humidity": [40.0, 44.0, 48.0],
            "Rainfall": [False, True, False],
            # WindSpeed column absent entirely -> default 5
        }
    )
    backend, fake = backend_for({(2024, "Bahrain", "R"): FakeSession(weather=w)})
    out = backend.load_weather(2024, "Bahrain", "R")
    assert out == {
        "air_temp": 25.0,
        "track_temp": 35,  # NaN-safe default (reference data_loader.py:141-145)
        "humidity": 44.0,
        "rainfall": True,  # any() — one wet reading flags the session
        "wind_speed": 5,
    }
    # Weather loads request only weather data (no laps/telemetry download).
    sess = fake.get_session(2024, "Bahrain", "R")
    assert sess.load_calls[0] == {
        "weather": True, "laps": False, "telemetry": False, "messages": False
    }


def test_load_weather_no_rainfall_column(backend_for):
    w = pd.DataFrame({"AirTemp": [20.0]})
    backend, _ = backend_for({(2024, "X", "Q"): FakeSession(weather=w)})
    out = backend.load_weather(2024, "X", "Q")
    assert out["rainfall"] is False
    assert out["air_temp"] == 20.0


def test_load_weather_failure_and_empty(backend_for):
    backend, _ = backend_for(
        {
            (2024, "A", "R"): FakeSession(weather=pd.DataFrame()),
            (2024, "B", "R"): FakeSession(weather=None, fail=True),
        }
    )
    assert backend.load_weather(2024, "A", "R") is None
    assert backend.load_weather(2024, "B", "R") is None


# -- schedule -----------------------------------------------------------------


def test_get_schedule_normalizes_events(backend_for):
    schedule = pd.DataFrame(
        {
            "EventName": ["Bahrain Grand Prix", "Chinese Grand Prix"],
            "Location": ["Sakhir", "Shanghai"],
            "EventFormat": ["conventional", "sprint_qualifying"],
            "EventDate": [pd.Timestamp("2024-03-02"), pd.Timestamp("2024-04-21")],
            "RoundNumber": [1, 2],
        }
    )
    backend, _ = backend_for({}, schedule=schedule)
    events = backend.get_schedule(2024)
    assert [e["EventName"] for e in events] == [
        "Bahrain Grand Prix", "Chinese Grand Prix"
    ]
    assert events[0]["Location"] == "Sakhir"
    assert events[1]["EventFormat"] == "sprint_qualifying"
    assert events[0]["EventDate"] == pd.Timestamp("2024-03-02")
    assert [e["RoundNumber"] for e in events] == [1, 2]


# -- loader integration: caching + offline ------------------------------------


def test_loader_caches_backend_loads_to_disk(backend_for, tmp_path):
    """First load goes through the stubbed network backend and is persisted;
    a second loader (offline, no backend) serves it from the parquet cache
    byte-identically."""
    backend, fake = backend_for(
        {(2024, "Bahrain Grand Prix", "FP2"): FakeSession(laps=laps_frame())},
        schedule=pd.DataFrame(
            {
                "EventName": ["Bahrain Grand Prix"],
                "Location": ["Sakhir"],
                "EventFormat": ["conventional"],
                "EventDate": [pd.Timestamp("2024-03-02")],
                "RoundNumber": [1],
            }
        ),
    )
    cache_dir = tmp_path / "cache"
    loader = F1DataLoader(cache_dir=cache_dir, backend=backend)
    # 'Bahrain' resolves to the schedule's 'Bahrain Grand Prix'.
    first = loader.load_session(2024, "Bahrain", "FP2")
    assert not first.empty
    n_network = len(fake.session_requests)

    offline = F1DataLoader(cache_dir=cache_dir, offline=True)
    assert offline.backend is None
    cached = offline.load_session(2024, "Bahrain", "FP2")
    pd.testing.assert_frame_equal(first.reset_index(drop=True), cached)
    assert len(fake.session_requests) == n_network  # no new network traffic


def test_offline_loader_never_touches_backend(backend_for, tmp_path):
    """offline=True with an injected backend must not call it — the cache
    alone answers (the reference README's promised-but-unimplemented
    --offline semantics, SURVEY.md preamble)."""
    backend, fake = backend_for(
        {(2024, "Bahrain", "FP2"): FakeSession(laps=laps_frame())}
    )
    loader = F1DataLoader(cache_dir=tmp_path / "empty", offline=True, backend=backend)
    out = loader.load_session(2024, "Bahrain", "FP2")
    assert out.empty
    assert loader.get_schedule(2024) == []
    assert loader.get_weather(2024, "Bahrain", "R")["track_temp"] == 35
    assert fake.session_requests == []


# -- schedule-format edge cases (VERDICT r4 #5) -------------------------------


def _schedule_2023_style():
    """A schedule shaped like the pre-2024 API: a testing event, a
    conventional round, a sprint_shootout round (2023 format string), and a
    round whose EventDate is NaT but whose Session5Date is set (red-flag /
    rescheduled rows look like this)."""
    return pd.DataFrame(
        {
            "EventName": [
                "Pre-Season Testing",
                "Bahrain Grand Prix",
                "Azerbaijan Grand Prix",
                "Emilia Romagna Grand Prix",
                "Qatar Grand Prix",
            ],
            "Location": ["Sakhir", "Sakhir", "Baku", "Imola", "Lusail"],
            "EventFormat": [
                "testing", "conventional", "sprint_shootout", "conventional",
                "conventional",
            ],
            "EventDate": [
                pd.Timestamp("2023-02-23"),
                pd.Timestamp("2023-03-05"),
                pd.Timestamp("2023-04-30"),
                pd.NaT,   # falls back to Session5Date
                pd.NaT,   # no date at all (rescheduled/unknown)
            ],
            "Session5Date": [
                pd.NaT,
                pd.Timestamp("2023-03-05 15:00"),
                pd.Timestamp("2023-04-30 15:00"),
                pd.Timestamp("2023-05-21 15:00"),
                pd.NaT,
            ],
            "RoundNumber": [0, 1, 4, 6, 18],
        }
    )


def test_schedule_event_date_falls_back_to_session5date(backend_for):
    backend, _ = backend_for({}, schedule=_schedule_2023_style())
    events = backend.get_schedule(2023)
    imola = next(e for e in events if e["EventName"].startswith("Emilia"))
    # Series.get returns the stored NaT, not the default — the backend must
    # fall through to Session5Date explicitly.
    assert imola["EventDate"] == pd.Timestamp("2023-05-21 15:00")


def test_past_events_excludes_testing_and_orders_by_clock(backend_for, tmp_path):
    backend, _ = backend_for({}, schedule=_schedule_2023_style())
    loader = F1DataLoader(
        cache_dir=tmp_path, backend=backend,
        now=pd.Timestamp("2023-05-01", tz="UTC"),
    )
    names = [e["EventName"] for e in loader.past_events(2023)]
    assert "Pre-Season Testing" not in names
    # Qatar (fully dateless) passes the unpinned filter (reference-parity
    # permissiveness, data_loader.py:48-60); Imola got its date from
    # Session5Date and is correctly future-filtered at May 1st.
    assert names == [
        "Bahrain Grand Prix", "Azerbaijan Grand Prix", "Qatar Grand Prix",
    ]
    # Strict (pinned) clock: the dateless event is excluded; Imola's
    # Session5Date-derived date now orders it normally.
    loader.set_now(pd.Timestamp("2023-12-01", tz="UTC"))
    names = [e["EventName"] for e in loader.past_events(2023)]
    assert "Qatar Grand Prix" not in names
    assert "Emilia Romagna Grand Prix" in names


def race_laps_frame():
    """Race-style laps: Position present so extract_race_results yields a
    classification (driver's last-lap Position)."""
    f = laps_frame()
    f["Position"] = [2.0, 1.0, 2.0]
    return f


def _sprint_session_set(season, event):
    """Sessions for one sprint event: Q/R plus SQ/S (race-style frames for
    the classification sessions)."""
    return {
        (season, event, "Q"): FakeSession(laps=laps_frame()),
        (season, event, "SQ"): FakeSession(laps=laps_frame()),
        (season, event, "R"): FakeSession(laps=race_laps_frame()),
        (season, event, "S"): FakeSession(laps=race_laps_frame()),
    }


@pytest.mark.parametrize("fmt", ["sprint", "sprint_qualifying", "sprint_shootout"])
def test_load_season_data_requests_sprint_sessions_for_all_formats(
    backend_for, tmp_path, fmt
):
    """Every historical sprint EventFormat string (2021-22 'sprint', 2023
    'sprint_shootout', 2024+ 'sprint_qualifying') triggers SQ+S extraction
    (reference data_loader.py:61-79 iterates sprint weekends)."""
    schedule = pd.DataFrame(
        {
            "EventName": ["Azerbaijan Grand Prix"],
            "Location": ["Baku"],
            "EventFormat": [fmt],
            "EventDate": [pd.Timestamp("2023-04-30")],
            "RoundNumber": [4],
        }
    )
    backend, fake = backend_for(
        _sprint_session_set(2023, "Azerbaijan Grand Prix"),
        schedule=schedule,
    )
    loader = F1DataLoader(
        cache_dir=tmp_path, backend=backend,
        now=pd.Timestamp("2023-12-01", tz="UTC"),
    )
    data = loader.load_season_data(2023)
    requested = {s for (_, _, s) in fake.session_requests}
    assert {"Q", "R", "SQ", "S"} <= requested
    assert len(data["sprint_qualifying"]) == 1
    assert len(data["sprints"]) == 1


def test_conventional_event_never_requests_sprint_sessions(backend_for, tmp_path):
    schedule = pd.DataFrame(
        {
            "EventName": ["Bahrain Grand Prix"],
            "Location": ["Sakhir"],
            "EventFormat": ["conventional"],
            "EventDate": [pd.Timestamp("2023-03-05")],
            "RoundNumber": [1],
        }
    )
    backend, fake = backend_for(
        {
            (2023, "Bahrain Grand Prix", "Q"): FakeSession(laps=laps_frame()),
            (2023, "Bahrain Grand Prix", "R"): FakeSession(laps=laps_frame()),
        },
        schedule=schedule,
    )
    loader = F1DataLoader(
        cache_dir=tmp_path, backend=backend,
        now=pd.Timestamp("2023-12-01", tz="UTC"),
    )
    loader.load_season_data(2023)
    requested = {s for (_, _, s) in fake.session_requests}
    assert "SQ" not in requested and "S" not in requested


def test_build_cache_skips_testing_events(backend_for, tmp_path):
    backend, fake = backend_for(
        {
            (2023, "Bahrain Grand Prix", s): FakeSession(laps=laps_frame())
            for s in ("FP1", "FP2", "FP3", "Q", "R")
        },
        schedule=_schedule_2023_style(),
    )
    loader = F1DataLoader(cache_dir=tmp_path, backend=backend)
    loader.build_cache([2023], sessions=("FP2", "Q", "R"))
    events_requested = {e for (_, e, _) in fake.session_requests}
    assert "Pre-Season Testing" not in events_requested
    assert "Bahrain Grand Prix" in events_requested


# -- NaN Grid/Position rows (red-flagged races) --------------------------------


def results_frame_red_flagged():
    """A classification like a red-flagged race: NaN GridPosition for a
    pit-lane starter, NaN Position for DNS/withdrawn cars."""
    return pd.DataFrame(
        {
            "Abbreviation": ["VER", "HAM", "LEC", "STR"],
            "GridPosition": [1.0, np.nan, 3.0, 4.0],
            "Position": [1.0, 2.0, np.nan, np.nan],
            "Status": ["Finished", "Finished", "Accident", "Withdrew"],
        }
    )


def test_load_results_passes_nan_rows_through(backend_for):
    backend, _ = backend_for(
        {(2021, "Belgian Grand Prix", "R"): FakeSession(
            results=results_frame_red_flagged())}
    )
    out = backend.load_results(2021, "Belgian Grand Prix", "R")
    assert len(out) == 4
    assert np.isnan(out["GridPosition"].iloc[1])
    assert np.isnan(out["Position"].iloc[2])


def test_actual_results_drop_nan_positions(backend_for, tmp_path):
    from monte_carlo_gp.validate.backtest import get_actual_results

    schedule = pd.DataFrame(
        {
            "EventName": ["Belgian Grand Prix"],
            "Location": ["Spa"],
            "EventFormat": ["conventional"],
            "EventDate": [pd.Timestamp("2021-08-29")],
            "RoundNumber": [12],
        }
    )
    backend, _ = backend_for(
        {
            (2021, "Belgian Grand Prix", "R"): FakeSession(
                results=results_frame_red_flagged()),
            (2021, "Belgian Grand Prix", "Q"): FakeSession(
                results=results_frame_red_flagged()),
        },
        schedule=schedule,
    )
    loader = F1DataLoader(cache_dir=tmp_path, backend=backend)
    act = get_actual_results(loader, 2021, "Belgian Grand Prix")
    # NaN-Position rows are classification-less: excluded from orderings.
    assert act["race_results"] == ["VER", "HAM"]
    assert act["winner"] == "VER"
    assert "LEC" not in act["race_results"]


def test_feature_archive_tolerates_nan_result_rows(backend_for, tmp_path):
    """The feature engine's per-event aggregates must survive NaN
    grid/finish rows (pandas NaN-skipping means they simply don't
    contribute to overtake/defense rates)."""
    from monte_carlo_gp.models.features import F1FeatureEngine

    schedule = pd.DataFrame(
        {
            "EventName": ["Belgian Grand Prix"],
            "Location": ["Spa"],
            "EventFormat": ["conventional"],
            "EventDate": [pd.Timestamp("2021-08-29")],
            "RoundNumber": [12],
        }
    )
    backend, _ = backend_for(
        {
            (2021, "Belgian Grand Prix", "Q"): FakeSession(laps=laps_frame()),
            (2021, "Belgian Grand Prix", "R"): FakeSession(
                laps=laps_frame(), results=results_frame_red_flagged()),
        },
        schedule=schedule,
    )
    loader = F1DataLoader(
        cache_dir=tmp_path, backend=backend,
        now=pd.Timestamp("2021-12-01", tz="UTC"),
    )
    eng = F1FeatureEngine(loader)
    eng.load_historical_data([2021])
    assert not eng.race_results.empty
    from monte_carlo_gp.data.loader import DEFAULT_WEATHER

    feats = eng.calculate_race_features(
        "VER", circuit="Belgian Grand Prix", weather=dict(DEFAULT_WEATHER))
    assert np.isfinite(feats["overtake_rate"])
    feats_nan = eng.calculate_race_features(
        "LEC", circuit="Belgian Grand Prix", weather=dict(DEFAULT_WEATHER))
    assert np.isfinite(feats_nan["overtake_rate"])  # default, not NaN


# -- recorded-fixture round trip: build_cache -> offline predict_weekend ------


def _fixture_world(seasons=(2023, 2024)):
    """A small but complete recorded world through the fastf1 stub: 8
    drivers / 4 teams, 2 conventional events + FP2 for the target weekend,
    Timedelta-typed laps, classification results and weather — enough for
    the full offline pipeline (Elo build, feature archive, practice
    extraction) to run for real."""
    rng = np.random.default_rng(7)
    drivers = ["VER", "PER", "HAM", "RUS", "LEC", "SAI", "NOR", "PIA"]
    teams = {
        "VER": "Red Bull Racing", "PER": "Red Bull Racing",
        "HAM": "Mercedes", "RUS": "Mercedes",
        "LEC": "Ferrari", "SAI": "Ferrari",
        "NOR": "McLaren", "PIA": "McLaren",
    }
    base = {d: 90.0 + 0.12 * i for i, d in enumerate(drivers)}

    def laps(session, n_laps, season, ev_i):
        rows = []
        for d in drivers:
            for k in range(n_laps):
                t = base[d] + rng.normal(0, 0.25) + (0.02 * k)
                rows.append({
                    "Driver": d, "Team": teams[d],
                    "LapTime": td(t), "LapNumber": float(k + 1),
                    "Sector1Time": td(t * 0.31), "Sector2Time": td(t * 0.37),
                    "Sector3Time": td(t * 0.32),
                    "Compound": "SOFT" if session in ("Q",) else "MEDIUM",
                    "IsAccurate": True,
                    "PitInTime": pd.NaT, "PitOutTime": pd.NaT,
                    "Deleted": False, "TrackTemp": 40.0 + ev_i,
                    "Rainfall": False, "Stint": 1.0,
                    "TyreLife": float(k + 1),
                    "Position": float(sorted(drivers, key=lambda x: base[x])
                                      .index(d) + 1),
                })
        return pd.DataFrame(rows)

    def results():
        order = sorted(drivers, key=lambda x: base[x])
        return pd.DataFrame({
            "Abbreviation": order,
            "GridPosition": [float(i + 1) for i in range(len(order))],
            "Position": [float(i + 1) for i in range(len(order))],
            "Status": ["Finished"] * len(order),
        })

    def weather():
        return pd.DataFrame({
            "AirTemp": [28.0, 29.0], "TrackTemp": [41.0, 42.0],
            "Humidity": [40.0, 42.0], "Rainfall": [False, False],
            "WindSpeed": [2.0, 2.5],
        })

    events = ["Bahrain Grand Prix", "Saudi Arabian Grand Prix"]
    sessions = {}
    schedules = {}
    for season in seasons:
        schedules[season] = pd.DataFrame({
            "EventName": events,
            "Location": ["Sakhir", "Jeddah"],
            "EventFormat": ["conventional", "conventional"],
            "EventDate": [pd.Timestamp(f"{season}-03-02"),
                          pd.Timestamp(f"{season}-03-09")],
            "RoundNumber": [1, 2],
        })
        for ev_i, ev in enumerate(events):
            for sess, n in (("FP1", 6), ("FP2", 8), ("FP3", 5),
                            ("Q", 4), ("R", 10)):
                sessions[(season, ev, sess)] = FakeSession(
                    laps=laps(sess, n, season, ev_i),
                    results=results() if sess in ("Q", "R") else None,
                    weather=weather(),
                )
    return sessions, schedules, drivers


@pytest.mark.slow
def test_build_cache_offline_predict_roundtrip(monkeypatch, tmp_path):
    """VERDICT r4 #5: record a world through the stubbed FastF1 backend
    with build_cache, then run the COMPLETE offline prediction pipeline
    (Elo build + features + practice extraction + Monte Carlo) against the
    recorded cache with no backend at all — the production offline mode
    end-to-end over FastF1-shaped (Timedelta-typed) data."""
    sessions, schedules, drivers = _fixture_world()
    fake = make_fake_fastf1(sessions)
    fake.get_event_schedule = lambda season: schedules[season]
    monkeypatch.setitem(sys.modules, "fastf1", fake)
    from monte_carlo_gp.data.loader import FastF1Backend

    backend = FastF1Backend(str(tmp_path / "ff1"))
    cache_dir = tmp_path / "cache"
    loader = F1DataLoader(cache_dir=cache_dir, backend=backend)
    written = loader.build_cache([2023, 2024])
    assert written > 0

    from monte_carlo_gp.models.predictor import F1Predictor

    predictor = F1Predictor(cache_dir=cache_dir, offline=True, engine="xla")
    assert predictor.data_loader.backend is None  # truly offline
    n_before = len(fake.session_requests)
    result = predictor.predict_weekend(
        2024, "Bahrain", n_simulations=256, seed=3
    )
    assert len(fake.session_requests) == n_before  # zero network traffic

    assert set(result["win_probabilities"]) == set(drivers)
    assert abs(sum(result["win_probabilities"].values()) - 1.0) < 1e-3
    # Pole probabilities are the reference's gaussian-shaped per-driver
    # position distributions (reference predictor.py:358-374) — rows sum
    # to 1, the pole COLUMN does not (especially on a flat-Elo world), so
    # only shape/range is asserted here.
    assert set(result["pole_probabilities"]) == set(drivers)
    assert all(0.0 <= v <= 1.0 for v in result["pole_probabilities"].values())
    # On a 4-event flat-Elo world the grid is nearly uniform and overtaking
    # has friction, so the favorite need not be the outright fastest car —
    # but it must come from the faster half of the recorded pace order.
    fav = max(result["win_probabilities"], key=result["win_probabilities"].get)
    assert fav in ("VER", "PER", "HAM", "RUS"), result["win_probabilities"]
    # Reproducibility across fresh offline predictors.
    again = F1Predictor(
        cache_dir=cache_dir, offline=True, engine="xla"
    ).predict_weekend(2024, "Bahrain", n_simulations=256, seed=3)
    assert again["win_probabilities"] == result["win_probabilities"]
