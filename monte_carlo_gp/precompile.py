"""Pre-seed the persistent compilation cache.

A season run's dominant first-run cost is compiling the engine's
lap-bucket programs. Lap counts bucket to multiples of 16
(`models/predictor._lap_bucket`), so the whole 2025 calendar needs only a
handful of distinct programs per n_simulations; this module compiles
exactly those, in this one process, into the persistent cache
(`monte_carlo_gp.compile_cache_dir`) as a deployment/build step:

    python -m monte_carlo_gp.precompile --simulations 10000

After it runs, `main.py` predictions and season backtests start
compile-warm on this machine for that simulation count. The compiles run
one after another in this process: a second JAX process would need the
device this one holds.

Why not AOT `jax.export` artifacts instead: the persistent cache already
IS the durable artifact (keyed to the host fingerprint — foreign-machine
XLA:CPU AOT entries can SIGILL, see monte_carlo_gp.__init__), and it
needs no load-path changes in the engine. Exported artifacts would add
a second serialization surface for the same win.

The compile goes through `F1Predictor.simulate_plan` itself — the same
code path real predictions take — so the seeded cache keys can never
drift from production tracing (race_laps trip-count handling, blocking).
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

from monte_carlo_gp import config as cfg
from monte_carlo_gp.utils.logging import get_logger, log_event


def bucket_specs(circuits: dict | None = None) -> list[tuple[int, int]]:
    """Distinct (bucket, representative_total_laps) programs the calendar
    needs. A circuit whose lap count IS its bucket traces the static-trip
    variant (race_laps=None) — a different program — so exact-multiple
    circuits contribute their own spec."""
    from monte_carlo_gp.models.predictor import _lap_bucket

    circuits = circuits or cfg.CIRCUITS
    specs: dict[tuple[int, bool], int] = {}
    for info in circuits.values():
        laps = int(info["laps"])
        bucket = _lap_bucket(laps)
        exact = laps == bucket
        # keep one representative; any non-exact laps value traces the
        # same program (the actual count is a traced scalar)
        specs.setdefault((bucket, exact), laps)
    return sorted((b, laps) for (b, _), laps in specs.items())


def _dummy_plan(n_drivers: int, total_laps: int):
    """A plan-shaped object with production array shapes; values are
    irrelevant (compilation is keyed on shapes/statics only)."""
    import numpy as np

    d = n_drivers
    gp = np.full((d, d), 1.0 / d, np.float32)
    params = cfg.make_sim_params(
        grid_probs=gp,
        base_pace=90.0 + 0.05 * np.arange(d),
        tire_deg=np.full(d, 0.05),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.001),
        team_dnf_rate=np.full(d, 0.002),
    )
    return SimpleNamespace(params=params, total_laps=int(total_laps))


def compile_one(total_laps: int, n_simulations: int, n_drivers: int) -> float:
    """Compile (and once execute) the engine program for one lap bucket
    through the production dispatch. Returns wall-clock seconds."""
    from monte_carlo_gp.models.predictor import F1Predictor

    predictor = F1Predictor.__new__(F1Predictor)  # engine dispatch only
    predictor._sims_per_block = None
    predictor.last_effective_sims = None
    t0 = time.perf_counter()
    predictor.simulate_plan(
        _dummy_plan(n_drivers, total_laps), n_simulations, seed=0
    )
    return time.perf_counter() - t0


def compile_season(n_races: int, n_simulations: int, n_drivers: int) -> float:
    """Compile the race-batched season program (`backtest --batched`):
    ONE launch whose compile is keyed on (n_races, max lap count, sims)
    — a different program from the per-race path, so the
    build step seeds it separately. Lap counts come from the real
    calendar (the per-race count is traced data, not a compile key)."""
    from monte_carlo_gp.models.predictor import F1Predictor
    from monte_carlo_gp.validate.backtest import simulate_season_plans

    laps = [int(i["laps"]) for i in cfg.CIRCUITS.values()]
    laps = (laps * (1 + n_races // len(laps)))[:n_races]
    plans = [_dummy_plan(n_drivers, lp) for lp in laps]
    predictor = F1Predictor.__new__(F1Predictor)  # engine dispatch only
    predictor.last_effective_sims = None
    import jax

    t0 = time.perf_counter()
    simulate_season_plans(predictor, plans, jax.random.PRNGKey(0), n_simulations)
    return time.perf_counter() - t0


def precompile(
    n_simulations: int = 10_000,
    engine: str = "auto",
    n_drivers: int = 20,
    season_races: int = 0,
) -> int:
    """Seed the persistent cache for every calendar lap bucket, in this
    process. Returns the number of programs compiled."""
    from monte_carlo_gp.models.predictor import resolve_engine

    engine = resolve_engine(engine)
    specs = bucket_specs()
    t0 = time.perf_counter()
    for _, laps in specs:
        dt = compile_one(laps, n_simulations, n_drivers)
        get_logger().info(
            "precompiled laps=%d sims=%d in %.1fs", laps, n_simulations, dt
        )
    n_programs = len(specs)
    if season_races > 0:
        compile_season(season_races, n_simulations, n_drivers)
        n_programs += 1
    dt = time.perf_counter() - t0
    log_event(
        "precompile", programs=n_programs, engine=engine,
        n_simulations=n_simulations, seconds=round(dt, 1),
    )
    print(
        f"precompiled {n_programs} engine programs "
        f"({engine}, {n_simulations} sims, {n_drivers} drivers) "
        f"in {dt:.1f}s",
        flush=True,
    )
    return n_programs


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Pre-seed the persistent compile cache with every "
        "calendar lap-bucket engine program"
    )
    parser.add_argument("--simulations", type=int, default=10_000)
    parser.add_argument("--engine", choices=["auto", "xla"], default="auto")
    parser.add_argument("--drivers", type=int, default=20)
    parser.add_argument(
        "--season-races", type=int, default=0, metavar="N",
        help="also compile the race-batched season program for an N-race "
             "season (the `backtest --batched` path; a separate program)",
    )
    args = parser.parse_args()
    precompile(
        n_simulations=args.simulations, engine=args.engine,
        n_drivers=args.drivers, season_races=args.season_races,
    )


if __name__ == "__main__":
    main()
