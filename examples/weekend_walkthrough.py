"""Worked example: everything a reference user does, on this framework.

Runs against the deterministic synthetic data backend so it works offline.
For real data, drop `backend=` (FastF1 required) or point `cache_dir` at a
cache built with `python main.py --build-cache --seasons ...`.

    python examples/weekend_walkthrough.py
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import jax

from monte_carlo_gp.data.synthetic import SyntheticBackend
from monte_carlo_gp.models.predictor import F1Predictor
from monte_carlo_gp.parallel.sharded import simulate_season_sharded
from monte_carlo_gp.validate.backtest import get_actual_results, get_races


def top3(probs: dict) -> str:
    ranked = sorted(probs.items(), key=lambda kv: kv[1], reverse=True)[:3]
    return ", ".join(f"{d} {p:.1%}" for d, p in ranked)


def main():
    # Smaller counts (e.g. MCGP_EXAMPLE_SIMS=1024) keep the walkthrough
    # quick on CPU; the default is the reference's 10k order of magnitude.
    n_sims = int(os.environ.get("MCGP_EXAMPLE_SIMS", "20000"))
    backend = SyntheticBackend(seed=2718, n_events=6)
    predictor = F1Predictor(cache_dir="./cache/example", backend=backend)

    # 1. Basic weekend prediction from FP2 (the reference's default flow).
    print("=== FP2 prediction, Bahrain ===")
    r = predictor.predict_weekend(2024, "Bahrain", n_simulations=n_sims, seed=1)
    print("win:", top3(r["win_probabilities"]))
    print("podium:", top3(r["podium_probabilities"]))

    # 2. Grid penalties: an engine change (+10) for the likely pole-sitter.
    likely_pole = max(r["pole_probabilities"], key=r["pole_probabilities"].get)
    print(f"\n=== same weekend, {likely_pole} takes an engine penalty ===")
    pen = predictor.predict_weekend(
        2024, "Bahrain", grid_penalties={likely_pole: "engine"},
        n_simulations=n_sims, seed=1,
    )
    print("win:", top3(pen["win_probabilities"]))

    # 3. Post-qualifying prediction with the actual grid.
    q = backend.load_results(2024, "Bahrain Grand Prix", "Q")
    grid = dict(zip(q["Abbreviation"], q["Position"].astype(int)))
    print("\n=== post-quali (actual grid) ===")
    post = predictor.predict_weekend(
        2024, "Bahrain", prediction_point="quali", actual_grid=grid,
        n_simulations=n_sims, seed=1,
    )
    print("confidence:", post["confidence"], "| win:", top3(post["win_probabilities"]))

    # 4. A whole season simulated as ONE sharded device batch.
    print("\n=== season batch: every race in one compile ===")
    races = get_races(predictor.data_loader, 2024)
    plans = [predictor.prepare_weekend(2024, race) for race in races]
    probs = simulate_season_sharded(
        [p.params for p in plans],
        [p.total_laps for p in plans],
        jax.random.PRNGKey(7),
        n_sims=min(8192, n_sims),
    )
    for race, plan, p in zip(races, plans, probs):
        result = predictor.assemble_result(plan, p[: len(plan.drivers), : len(plan.drivers)])
        act = get_actual_results(predictor.data_loader, 2024, race)
        predicted = max(result["win_probabilities"], key=result["win_probabilities"].get)
        print(f"  {race:<28} predicted {predicted}, actual {act['winner']}")


if __name__ == "__main__":
    main()
