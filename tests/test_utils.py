"""Utilities: phase timers and structured logging."""

import json
import logging

from monte_carlo_gp.utils.logging import get_logger, log_event
from monte_carlo_gp.utils.profiling import Phase, phase_report, sims_per_second


def test_phase_timers_accumulate():
    timers = Phase()
    with timers("a"):
        pass
    with timers("a"):
        pass
    with timers("b"):
        pass
    assert timers.counts == {"a": 2, "b": 1}
    report = phase_report(timers)
    assert "a" in report and "(2x)" in report


def test_sims_per_second():
    assert sims_per_second(1000, 2.0) == 500.0
    assert sims_per_second(1000, 2.0, n_chips=4) == 125.0


def test_log_event_plain_and_json(monkeypatch, caplog):
    get_logger()
    with caplog.at_level(logging.INFO, logger="mcgp"):
        log_event("bench", value=42)
    assert "bench" in caplog.text and "value=42" in caplog.text
    caplog.clear()
    monkeypatch.setenv("MCGP_LOG_JSON", "1")
    with caplog.at_level(logging.INFO, logger="mcgp"):
        log_event("bench", value=42)
    payload = json.loads(caplog.records[-1].message)
    assert payload["event"] == "bench" and payload["value"] == 42


# -- precompile (persistent-cache pre-seeding) --------------------------------


def test_bucket_specs_cover_calendar():
    from monte_carlo_gp import config as cfg
    from monte_carlo_gp.models.predictor import _lap_bucket
    from monte_carlo_gp.precompile import bucket_specs

    specs = bucket_specs()
    buckets = {b for b, _ in specs}
    # every circuit's bucket is covered
    assert {_lap_bucket(int(i["laps"])) for i in cfg.CIRCUITS.values()} == buckets
    # representatives trace the same variant as their bucket-mates
    for b, laps in specs:
        assert _lap_bucket(laps) == b
    # exact-multiple circuits (race_laps=None static variant) get their own
    # spec when present in the calendar
    exact = [(b, laps) for b, laps in specs if b == laps]
    calendar_exact = [
        int(i["laps"]) for i in cfg.CIRCUITS.values()
        if _lap_bucket(int(i["laps"])) == int(i["laps"])
    ]
    assert bool(exact) == bool(calendar_exact)


def test_precompile_one_bucket_in_process():
    """compile_one drives the production simulate_plan dispatch with a
    dummy plan: it must compile+run without a real predictor."""
    from monte_carlo_gp.precompile import compile_one

    dt = compile_one(12, 64, n_drivers=6)
    assert dt > 0


def test_precompile_spawns_no_subprocess(monkeypatch):
    """The whole build step compiles in this one process: a second JAX
    process would need the device this one holds."""
    import multiprocessing
    import subprocess

    import monte_carlo_gp.precompile as pc

    def forbidden(*a, **k):
        raise AssertionError("precompile started another process")

    monkeypatch.setattr(subprocess, "Popen", forbidden)
    monkeypatch.setattr(subprocess, "run", forbidden)
    monkeypatch.setattr(multiprocessing, "Process", forbidden)
    monkeypatch.setattr(pc, "bucket_specs", lambda: [(16, 12)])
    assert pc.precompile(n_simulations=64, n_drivers=4) == 1
