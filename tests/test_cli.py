"""CLI smoke tests: drive main.py / backtest.py as subprocesses on the
synthetic backend (the reference-parity surface)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
    "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
}


def run_cli(args, tmp_path, timeout=420):
    return subprocess.run(
        [sys.executable, *args, "--cache-dir", str(tmp_path / "cache")],
        cwd=REPO,
        env=ENV,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


@pytest.mark.slow
def test_main_cli_synthetic(tmp_path):
    out = run_cli(
        ["main.py", "--race", "Bahrain", "--season", "2024", "--synthetic",
         "--simulations", "512", "--seed", "3", "--engine", "xla"],
        tmp_path,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "POLE POSITION PROBABILITIES" in out.stdout
    assert "RACE WINNER PROBABILITIES" in out.stdout
    assert "PODIUM PROBABILITIES" in out.stdout
    assert "Prediction complete!" in out.stdout
    # output format parity: rank lines like " 1. VER   12.3% ###"
    assert any(
        line.strip().startswith("1.") and "%" in line
        for line in out.stdout.splitlines()
    )


@pytest.mark.slow
def test_main_cli_build_cache_then_offline(tmp_path):
    built = run_cli(
        ["main.py", "--build-cache", "--seasons", "2024", "--synthetic"],
        tmp_path,
    )
    assert built.returncode == 0, built.stderr[-2000:]
    assert "Cached" in built.stdout
    # now fully offline (no --synthetic): everything must come from disk
    out = run_cli(
        ["main.py", "--race", "Bahrain", "--season", "2024", "--offline",
         "--simulations", "256", "--engine", "xla"],
        tmp_path,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Prediction complete!" in out.stdout


@pytest.mark.slow
def test_main_cli_safe_fallback(tmp_path):
    """--safe degrades an empty-data weekend to uniform fallback predictions
    (plan.md:2687-2760 wrapper) instead of exiting with an error."""
    out = run_cli(
        ["main.py", "--race", "Bahrain", "--season", "2024", "--offline",
         "--safe"],
        tmp_path,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "using fallback predictions" in out.stdout
    assert "Confidence: none" in out.stdout
    assert "POLE POSITION PROBABILITIES" in out.stdout
    # Without --safe the same weekend is a hard error (original contract).
    out2 = run_cli(
        ["main.py", "--race", "Bahrain", "--season", "2024", "--offline"],
        tmp_path,
    )
    assert "Error: No practice data available" in out2.stdout
    # Hard errors exit nonzero so script chains see the failure.
    assert out2.returncode == 1


@pytest.mark.slow
def test_main_cli_requires_race(tmp_path):
    out = run_cli(["main.py", "--synthetic"], tmp_path, timeout=120)
    assert out.returncode != 0
    assert "--race is required" in out.stderr


_FAKE_FASTF1 = '''
"""File-based fastf1 stub: a fastf1-shaped facade over the deterministic
SyntheticBackend, DE-normalizing frames back to fastf1's dtypes (Timedelta
time columns, NaT pit markers) so FastF1Backend's real normalization path
runs end-to-end in a CLI subprocess. Every network-style call is appended
to $MCGP_FF1_CALL_LOG so tests can assert when the network was (not) hit."""
import os
import sys

sys.path.insert(0, os.environ["MCGP_REPO"])
import pandas as pd

from monte_carlo_gp.data.synthetic import SyntheticBackend

_backend = SyntheticBackend(
    seed=5, n_events=int(os.environ.get("MCGP_SYN_EVENTS", "3"))
)
_LOG = os.environ.get("MCGP_FF1_CALL_LOG")


class Cache:
    @staticmethod
    def enable_cache(path):
        pass


def _log(line):
    if _LOG:
        with open(_LOG, "a") as f:
            f.write(line + "\\n")


def _as_td(col):
    return col.map(
        lambda v: pd.NaT if pd.isna(v) else pd.Timedelta(seconds=float(v))
    )


class _Session:
    def __init__(self, season, event, session):
        self._key = (season, event, session)
        self.laps = None
        self.results = None
        self.weather_data = None

    def load(self, **kwargs):
        season, event, session = self._key
        raw = _backend.load_laps(season, event, session)
        if raw is not None and not raw.empty:
            laps = raw.copy()
            for c in ("LapTime", "Sector1Time", "Sector2Time", "Sector3Time",
                      "PitInTime", "PitOutTime"):
                if c in laps.columns:
                    laps[c] = _as_td(laps[c])
            self.laps = laps
        self.results = _backend.load_results(season, event, session)
        w = _backend.load_weather(season, event, session)
        if w is not None:
            self.weather_data = pd.DataFrame(
                {
                    "AirTemp": [w["air_temp"]],
                    "TrackTemp": [w["track_temp"]],
                    "Humidity": [w["humidity"]],
                    "Rainfall": [bool(w["rainfall"])],
                    "WindSpeed": [w["wind_speed"]],
                }
            )


def get_session(season, event, session):
    _log(f"get_session {season} {event} {session}")
    return _Session(season, event, session)


def get_event_schedule(season):
    _log(f"get_event_schedule {season}")
    return pd.DataFrame(_backend.get_schedule(season))
'''


@pytest.mark.slow
def test_main_cli_network_stub_build_cache_then_offline(tmp_path):
    """End-to-end --build-cache -> --offline through the REAL FastF1Backend
    driven by a file-based fastf1 stub (VERDICT r3 #8): the build pass pulls
    every session through the network path and persists normalized parquet;
    the offline prediction must then run WITHOUT a single network call and
    reproduce the prediction made while the network was still reachable."""
    stub_dir = tmp_path / "stubsite"
    stub_dir.mkdir()
    (stub_dir / "fastf1.py").write_text(_FAKE_FASTF1)
    call_log = tmp_path / "ff1_calls.log"
    env = {
        **ENV,
        "PYTHONPATH": str(stub_dir),
        "MCGP_REPO": str(REPO),
        "MCGP_FF1_CALL_LOG": str(call_log),
        "MCGP_SYN_EVENTS": "3",
    }

    def run(args, timeout=420):
        return subprocess.run(
            [sys.executable, *args, "--cache-dir", str(tmp_path / "cache")],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
        )

    built = run(["main.py", "--build-cache", "--seasons", "2023", "2024"])
    assert built.returncode == 0, built.stderr[-2000:]
    assert "Cached" in built.stdout
    assert call_log.exists() and "get_session" in call_log.read_text()

    predict = ["main.py", "--race", "Bahrain", "--season", "2024",
               "--simulations", "256", "--seed", "3", "--engine", "xla"]
    # online prediction: the stub is importable, but the disk cache built
    # above serves everything
    online = run(predict)
    assert online.returncode == 0, online.stderr[-2000:]
    assert "Prediction complete!" in online.stdout
    calls_before_offline = call_log.read_text()

    offline = run(predict + ["--offline"])
    assert offline.returncode == 0, offline.stderr[-2000:]
    assert "Prediction complete!" in offline.stdout
    # zero network-backend calls during the offline run
    assert call_log.read_text() == calls_before_offline
    # and the offline prediction reproduces the online one exactly
    assert offline.stdout == online.stdout


@pytest.mark.slow
def test_examples_walkthrough_runs(tmp_path):
    """The shipped worked example (examples/weekend_walkthrough.py) runs
    end-to-end on the synthetic world — docs that execute stay true."""
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "weekend_walkthrough.py")],
        cwd=tmp_path,  # the example writes ./cache/example relative to cwd
        env={**ENV, "MCGP_EXAMPLE_SIMS": "512"},  # CPU-sized Monte Carlo
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FP2 prediction" in out.stdout
    assert "post-quali (actual grid)" in out.stdout
    assert "season batch" in out.stdout
    # the season loop printed a prediction line per race
    assert out.stdout.count("predicted") >= 3
