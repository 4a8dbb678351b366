"""Data layer: synthetic backend determinism, offline disk cache round-trip,
season extraction, and the 3-level Elo cache priority."""

import numpy as np
import pandas as pd

from monte_carlo_gp.data.elo_cache import load_elo, load_with_priority, save_elo
from monte_carlo_gp.data.loader import (
    F1DataLoader,
    extract_quali_results,
    extract_race_results,
)
from monte_carlo_gp.data.synthetic import SyntheticBackend
from monte_carlo_gp.models.elo import F1EloSystem


def test_synthetic_deterministic():
    a = SyntheticBackend(seed=1).load_laps(2024, "Bahrain Grand Prix", "Q")
    b = SyntheticBackend(seed=1).load_laps(2024, "Bahrain Grand Prix", "Q")
    pd.testing.assert_frame_equal(a, b)
    c = SyntheticBackend(seed=2).load_laps(2024, "Bahrain Grand Prix", "Q")
    assert not a["LapTime"].equals(c["LapTime"])


def test_synthetic_schedule_and_sessions():
    backend = SyntheticBackend(seed=1)
    sched = backend.get_schedule(2024)
    assert len(sched) == 20
    assert any("sprint" in e["EventFormat"] for e in sched)
    laps = backend.load_laps(2024, "Monaco Grand Prix", "FP2")
    assert {"Driver", "LapTime", "Compound", "LapNumber"} <= set(laps.columns)
    assert laps["Driver"].nunique() == 20
    res = backend.load_results(2024, "Monaco Grand Prix", "R")
    assert set(res["Position"]) == set(range(1, 21))
    assert (res["Status"] != "Finished").sum() >= 0
    w = backend.load_weather(2024, "Belgium Grand Prix", "R")
    assert w["rainfall"] is True  # Belgium is a wet round in the fixture


def test_extract_quali_results_filters_and_sorts():
    laps = pd.DataFrame(
        {
            "Driver": ["A", "A", "B", "B", "C"],
            "LapTime": [90.0, 85.0, 88.0, 86.0, np.nan],
            "IsAccurate": [True, False, True, True, True],
        }
    )
    out = extract_quali_results(laps)
    # A's 85.0 is inaccurate -> best accurate is 90.0; B best 86.0; C NaN dropped
    assert out == [("B", 86.0), ("A", 90.0)]


def test_extract_race_results_last_lap():
    laps = pd.DataFrame(
        {
            "Driver": ["A", "A", "B"],
            "LapNumber": [1, 2, 1],
            "Position": [2.0, 1.0, 2.0],
        }
    )
    assert sorted(extract_race_results(laps)) == [("A", 1), ("B", 2)]


def test_loader_offline_cache_roundtrip(tmp_path):
    backend = SyntheticBackend(seed=3, n_events=3)
    online = F1DataLoader(cache_dir=tmp_path, backend=backend)
    n = online.build_cache([2024], sessions=("FP2", "Q", "R"))
    assert n > 0
    # offline loader (no backend) must serve everything from disk
    offline = F1DataLoader(cache_dir=tmp_path, offline=True)
    assert offline.backend is None
    laps = offline.load_session(2024, "Bahrain Grand Prix", "Q")
    assert not laps.empty
    sched = offline.get_schedule(2024)
    assert len(sched) == 3
    season = offline.load_season_data(2024)
    assert len(season["qualifying"]) == 3
    assert len(season["races"]) == 3
    w = offline.get_weather(2024, "Bahrain Grand Prix", "R")
    assert "track_temp" in w
    # a session never cached -> empty frame, no crash
    missing = offline.load_session(2024, "Bahrain Grand Prix", "FP1")
    assert missing.empty


def test_loader_memoizes(tmp_path):
    backend = SyntheticBackend(seed=3, n_events=2)
    loader = F1DataLoader(cache_dir=tmp_path, backend=backend)
    a = loader.load_session(2024, "Bahrain Grand Prix", "Q")
    b = loader.load_session(2024, "Bahrain Grand Prix", "Q")
    assert a is b  # in-memory memo hit


def test_future_events_filtered(tmp_path):
    backend = SyntheticBackend(seed=3, n_events=5)
    # "now" before the 3rd event date (events 14 days apart from Mar 1)
    now = pd.Timestamp("2024-03-20", tz="UTC")
    loader = F1DataLoader(cache_dir=tmp_path, backend=backend, now=now)
    past = loader.past_events(2024)
    assert len(past) == 2


def test_elo_cache_roundtrip_and_priority(tmp_path):
    system = F1EloSystem()
    system.update_race_ratings([("VER", 1), ("NOR", 2), ("LEC", 3)])
    local = tmp_path / "elo_local.json"
    external = tmp_path / "elo_external.json"
    save_elo(system, local, processed_seasons=[2023, 2024])

    loaded, seasons = load_elo(local)
    assert seasons == [2023, 2024]
    assert abs(loaded.get_rating("VER", "race") - system.get_rating("VER", "race")) < 1e-4

    # priority: external wins when present
    other = F1EloSystem()
    other.update_race_ratings([("HAM", 1), ("RUS", 2)])
    save_elo(other, external, processed_seasons=[2022])
    got = load_with_priority(external, local)
    assert got is not None and got[2] == "external"
    assert "HAM" in got[0].names

    # missing external falls back to local
    got = load_with_priority(tmp_path / "nope.json", local)
    assert got is not None and got[2] == "local"
    # both missing -> None (compute level)
    assert load_with_priority(None, tmp_path / "nope.json") is None


def test_elo_cache_rejects_corrupt(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    assert load_elo(p) is None
    p.write_text('{"version": 99, "ratings": {}}')
    assert load_elo(p) is None


def test_predictor_elo_cache_roundtrip(tmp_path):
    """use_elo_cache=True persists ratings after a build and a fresh
    predictor resumes from them without reprocessing seasons."""
    from monte_carlo_gp.models.predictor import F1Predictor

    backend = SyntheticBackend(seed=5, n_events=2)
    p1 = F1Predictor(cache_dir=tmp_path, backend=backend, use_elo_cache=True)
    p1._build_elo(2024)
    assert (tmp_path / "elo_ratings.json").exists()
    r_before = p1.elo_system.get_rating("VER", "race")

    p2 = F1Predictor(cache_dir=tmp_path, backend=backend, use_elo_cache=True)
    assert p2._processed_seasons == p1._processed_seasons
    assert abs(p2.elo_system.get_rating("VER", "race") - r_before) < 1e-4
    # _build_elo is now a no-op for processed seasons (no double counting)
    p2._build_elo(2024)
    assert abs(p2.elo_system.get_rating("VER", "race") - r_before) < 1e-4


def test_synthetic_world_is_hash_seed_invariant():
    """The synthetic world must be identical in every process regardless of
    PYTHONHASHSEED — its per-team pace draws once iterated a string set,
    which permuted team performance per interpreter and made every
    statistical gate on synthetic data a different random realization per
    pytest run (reproducibility contract, CLAUDE.md)."""
    import subprocess
    import sys

    probe = (
        "import numpy as np;"
        "from monte_carlo_gp.data.synthetic import SyntheticBackend;"
        "b = SyntheticBackend(seed=5, n_events=3);"
        "print(b._skill(2024).tobytes().hex());"
        "print(sorted(b._team_pace.items())[:2])"
    )
    outs = [
        subprocess.run(
            [sys.executable, "-c", probe],
            env={
                "PYTHONHASHSEED": hs,
                "PATH": "/usr/bin:/bin",
                "JAX_PLATFORMS": "cpu",
            },
            capture_output=True,
            text=True,
            cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]),
            timeout=120,
        )
        for hs in ("0", "1", "31337")
    ]
    for o in outs:
        assert o.returncode == 0, o.stderr[-500:]
    assert outs[0].stdout == outs[1].stdout == outs[2].stdout, [
        o.stdout for o in outs
    ]


def test_offline_allows_offline_safe_synthetic_backend(tmp_path):
    """offline=True forbids NETWORK backends, not the synthetic generator
    (offline_safe=True): `--offline --synthetic` over an empty cache must
    serve the deterministic synthetic world instead of silently degrading
    to empty frames (the module docstring's offline contract)."""
    backend = SyntheticBackend(seed=3, n_events=2)
    loader = F1DataLoader(cache_dir=tmp_path, offline=True, backend=backend)
    sched = loader.get_schedule(2024)
    assert len(sched) == 2
    laps = loader.load_session(2024, "Bahrain Grand Prix", "Q")
    assert not laps.empty
    # A network-shaped backend (offline_safe False/absent) stays blocked.
    class _NetStub:
        name = "netstub"
        def get_schedule(self, season):  # pragma: no cover - must not run
            raise AssertionError("offline loader touched a network backend")
    blocked = F1DataLoader(
        cache_dir=tmp_path / "empty", offline=True, backend=_NetStub()
    )
    assert blocked.get_schedule(2024) == []
