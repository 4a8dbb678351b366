"""Validation metrics (exact values) and the walk-forward backtest harness
(end-to-end on synthetic data, checkpoint/resume)."""

import json

import pytest

from monte_carlo_gp.data.loader import F1DataLoader
from monte_carlo_gp.data.synthetic import SyntheticBackend
from monte_carlo_gp.models.predictor import F1Predictor
from monte_carlo_gp.validate.backtest import (
    backtest_model,
    get_actual_results,
    get_races,
)
from monte_carlo_gp.validate.metrics import (
    brier_score,
    calibration_analysis,
    podium_accuracy,
)


# -- metrics ----------------------------------------------------------------


def test_brier_score_exact():
    preds = [{"A": 0.8, "B": 0.2}]
    # actual A: ((0.8-1)^2 + (0.2-0)^2)/2 = (0.04+0.04)/2 = 0.04
    assert brier_score(preds, ["A"]) == pytest.approx(0.04)
    # actual B: ((0.8)^2 + (0.8)^2)/2 = 0.64
    assert brier_score(preds, ["B"]) == pytest.approx(0.64)
    # skipped races
    assert brier_score(preds, [None]) == 1.0
    assert brier_score([{}], ["A"]) == 1.0
    # invalid probabilities skipped
    assert brier_score([{"A": 1.5}], ["A"]) == 1.0


def test_podium_accuracy_exact():
    preds = [{"podium_probabilities": {"A": 0.9, "B": 0.8, "C": 0.7, "D": 0.1}}]
    acts = [{"podium": ["A", "B", "D"]}]
    assert podium_accuracy(preds, acts) == pytest.approx(2 / 3)
    assert podium_accuracy(preds, [{"podium": []}]) == 0.0


def test_calibration_analysis_shapes():
    preds = [
        {"win_probabilities": {f"D{i}": (0.05 * (i % 20)) for i in range(20)}}
        for _ in range(10)
    ]
    acts = [{"winner": "D19"} for _ in range(10)]
    out = calibration_analysis(preds, acts)
    assert len(out["prob_true"]) == len(out["prob_pred"]) > 0
    assert calibration_analysis([], []) == {"prob_true": [], "prob_pred": []}


# -- actuals extraction -------------------------------------------------------


def test_get_actual_results(tmp_path):
    backend = SyntheticBackend(seed=5, n_events=2)
    loader = F1DataLoader(cache_dir=tmp_path, backend=backend)
    races = get_races(loader, 2024)
    assert races == ["Bahrain Grand Prix", "Saudi Arabia Grand Prix"]
    act = get_actual_results(loader, 2024, races[0])
    assert act["winner"] == act["race_results"][0]
    assert act["pole"] == act["quali_results"][0]
    assert act["podium"] == act["race_results"][:3]
    assert len(act["race_results"]) == 20


# -- backtest harness ----------------------------------------------------------


def _factory(tmp_path, n_events=2):
    def make():
        return F1Predictor(
            cache_dir=tmp_path,
            backend=SyntheticBackend(seed=5, n_events=n_events),
        )

    return make


@pytest.mark.slow
def test_backtest_end_to_end(tmp_path):
    results = backtest_model(
        _factory(tmp_path), [2024], seed=42, n_simulations=400, verbose=False
    )
    assert results["n_races"] == 2
    assert 0.0 <= results["pole_brier"] <= 1.0
    assert 0.0 <= results["win_brier"] <= 1.0
    assert 0.0 <= results["podium_accuracy"] <= 1.0
    # deterministic under the same seed
    again = backtest_model(
        _factory(tmp_path), [2024], seed=42, n_simulations=400, verbose=False
    )
    assert again["win_brier"] == results["win_brier"]


@pytest.mark.slow
def test_backtest_checkpoint_resume(tmp_path):
    ckpt = tmp_path / "progress.jsonl"
    first = backtest_model(
        _factory(tmp_path), [2024], seed=42, n_simulations=400,
        checkpoint_path=ckpt, verbose=False,
    )
    lines = [json.loads(l) for l in ckpt.read_text().splitlines()]
    assert len(lines) == 2 and {l["race"] for l in lines} == {
        "Bahrain Grand Prix", "Saudi Arabia Grand Prix"
    }
    # resume: all races come from the checkpoint, results identical
    resumed = backtest_model(
        _factory(tmp_path), [2024], seed=999, n_simulations=7,  # would differ if re-run
        checkpoint_path=ckpt, verbose=False,
    )
    assert resumed["win_brier"] == first["win_brier"]
    assert resumed["n_races"] == 2


@pytest.mark.slow
def test_reference_compat_elo_noop_differs(tmp_path):
    """The corrected walk-forward Elo updates must change later-race
    predictions relative to the reference's silent no-op mode."""
    fixed = backtest_model(
        _factory(tmp_path, n_events=3), [2024], seed=1, n_simulations=400,
        verbose=False,
    )
    compat = backtest_model(
        _factory(tmp_path, n_events=3), [2024], seed=1, n_simulations=400,
        reference_compat_elo_noop=True, verbose=False,
    )
    assert fixed["n_races"] == compat["n_races"] == 3
    assert fixed["pole_brier"] != compat["pole_brier"]


@pytest.mark.slow
def test_batched_backtest_matches_sequential_scores(tmp_path):
    """The batched (sharded season) backtest must produce Brier scores
    statistically consistent with the sequential walk-forward harness."""
    from monte_carlo_gp.validate.backtest import backtest_model_batched

    seq = backtest_model(
        _factory(tmp_path, n_events=3), [2024], seed=3, n_simulations=1024,
        verbose=False,
    )
    bat = backtest_model_batched(
        _factory(tmp_path, n_events=3), [2024], seed=3, n_simulations=1024,
        verbose=False,
    )
    assert bat["n_races"] == seq["n_races"] == 3
    # pole Brier is simulation-free (quali model only) -> identical
    assert bat["pole_brier"] == pytest.approx(seq["pole_brier"], abs=1e-9)
    # win Brier differs only by Monte Carlo noise
    assert bat["win_brier"] == pytest.approx(seq["win_brier"], abs=0.02)


@pytest.mark.slow
def test_synthetic_ground_truth_accuracy_gate(tmp_path):
    """End-to-end 'does the pipeline actually predict' gate (SURVEY §4):
    backtest a synthetic season where the right answer (latent driver skill)
    is known and assert the model recovers it.

    Notes on the Brier bounds: the reference's quali model shapes position
    probabilities with a sigma = n/4 gaussian (predictor.py:358-374 — parity
    semantics), which caps the favorite's pole probability at ~0.11, so even
    PERFECT ranking yields pole Brier ~0.043 vs the 0.0475 random baseline.
    Likewise the synthetic world's race outcomes are ~50% luck
    (synthetic.py:_race_order noise 0.6 vs skill spread ~0.6) while the
    engine's pace-dominated world is far more deterministic, so win Brier
    reflects that calibration gap. The gates therefore assert (1) strong
    skill-rank recovery, (2) favorite hit-rates far above chance, and
    (3) Brier regression bounds."""
    import numpy as np
    from scipy import stats

    n_events = 12
    backend = SyntheticBackend(seed=5, n_events=n_events)
    predictor = F1Predictor(cache_dir=tmp_path, backend=backend)
    loader = predictor.data_loader
    from monte_carlo_gp.validate.backtest import _pin, _race_cutoffs

    races = get_races(loader, 2024)
    cutoffs = _race_cutoffs(loader, 2024)
    preds, acts = [], []
    for idx, race in enumerate(races):
        _pin(loader, cutoffs, idx, True)
        preds.append(
            predictor.predict_weekend(2024, race, n_simulations=1024, seed=idx)
        )
        act = get_actual_results(loader, 2024, race)
        acts.append(act)
        predictor.elo_system.update_quali_ratings(act["quali_results"])
        predictor.elo_system.update_race_ratings(act["race_results"])

    drivers = backend.drivers
    skill = backend._skill(2024)  # lower = faster

    # (1) mean predicted win probability recovers the latent skill ranking
    mean_win = np.array(
        [np.mean([p["win_probabilities"].get(d, 0.0) for p in preds]) for d in drivers]
    )
    rho = stats.spearmanr(mean_win, -skill).statistic
    assert rho > 0.7, (rho, dict(zip(drivers, mean_win)))

    # (2) favorites hit far above the ~15% chance rate. Thresholds sit well
    # BELOW the expected hit rates (~0.55-0.65) so the binomial noise of a
    # 12-race season cannot flake the test, while staying ~2.5x chance.
    pole_hits = win_top3 = 0
    for p, a in zip(preds, acts):
        pole_fav = max(p["pole_probabilities"], key=p["pole_probabilities"].get)
        win_fav = max(p["win_probabilities"], key=p["win_probabilities"].get)
        pole_hits += pole_fav in a["quali_results"][:3]  # chance 15%
        win_top3 += win_fav in a["race_results"][:3]  # chance 15%
    assert pole_hits / n_events >= 1 / 3, (pole_hits, n_events)
    assert win_top3 / n_events >= 1 / 3, (win_top3, n_events)

    # (3) Brier regression bounds (see docstring for why not < 0.0475)
    pole_brier = brier_score(
        [p["pole_probabilities"] for p in preds], [a["pole"] for a in acts]
    )
    win_brier = brier_score(
        [p["win_probabilities"] for p in preds], [a["winner"] for a in acts]
    )
    assert pole_brier < 0.06, pole_brier
    assert win_brier < 0.095, win_brier


@pytest.mark.slow
def test_partial_checkpoint_resume_matches_uninterrupted(tmp_path):
    """Resuming from a PARTIAL checkpoint must reproduce the uninterrupted
    run exactly: the historical Elo build has to land before the replayed
    actual-result updates (order-dependent)."""
    full = backtest_model(
        _factory(tmp_path, n_events=3), [2024], seed=42, n_simulations=256,
        verbose=False,
    )
    # build a checkpoint containing only the first race
    ckpt = tmp_path / "partial.jsonl"
    full_ckpt = tmp_path / "full.jsonl"
    backtest_model(
        _factory(tmp_path, n_events=3), [2024], seed=42, n_simulations=256,
        checkpoint_path=full_ckpt, verbose=False,
    )
    lines = full_ckpt.read_text().splitlines()
    assert len(lines) == 3
    ckpt.write_text(lines[0] + "\n")

    resumed = backtest_model(
        _factory(tmp_path, n_events=3), [2024], seed=42, n_simulations=256,
        checkpoint_path=ckpt, verbose=False,
    )
    # races 2-3 were re-simulated; Elo-dependent pole predictions must match
    assert resumed["pole_brier"] == pytest.approx(full["pole_brier"], abs=1e-9)
    assert resumed["win_brier"] == pytest.approx(full["win_brier"], abs=1e-9)


# -- mixed-field seasons (fields wider than the fused kernel's packing) --------


def _widen_plan(plan, width: int):
    """Widen a prepared weekend to `width` drivers by appending slow
    synthetic backmarkers: each fake qualifies one-hot at a tail grid slot
    and carries +5s/lap pace, so the real field's predictions are left
    essentially untouched while the driver axis exceeds the kernel caps."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    d = len(plan.drivers)
    if width <= d:
        return plan
    extra = width - d
    p = plan.params
    grid = np.zeros((width, width), np.float32)
    grid[:d, :d] = np.asarray(p.grid_probs)
    for j in range(extra):
        grid[d + j, d + j] = 1.0

    def pad(arr, fill):
        a = np.asarray(arr, np.float32)
        return np.concatenate([a, np.full(extra, fill, np.float32)])

    params = dataclasses.replace(
        p,
        grid_probs=jnp.asarray(grid),
        base_pace=jnp.asarray(
            pad(p.base_pace, float(np.asarray(p.base_pace).max()) + 5.0)
        ),
        tire_deg=jnp.asarray(pad(p.tire_deg, 0.05)),
        variance=jnp.asarray(pad(p.variance, 0.1)),
        dnf_rate=jnp.asarray(pad(p.dnf_rate, 0.001)),
        team_dnf_rate=jnp.asarray(pad(p.team_dnf_rate, 0.002)),
        active=jnp.concatenate(
            [jnp.asarray(p.active), jnp.ones(extra, bool)]
        ),
    )
    fakes = [f"X{j:02d}" for j in range(extra)]
    qp = {
        dr: list(np.asarray(plan.quali_probs[dr], float)) + [0.0] * extra
        for dr in plan.drivers
    }
    for j, f in enumerate(fakes):
        row = [0.0] * width
        row[d + j] = 1.0
        qp[f] = row
    return dataclasses.replace(
        plan, drivers=list(plan.drivers) + fakes, quali_probs=qp, params=params
    )


def _widening_factory(tmp_path, widths, n_events=2):
    """Predictor factory whose prepare_weekend widens race k's field to
    widths[k] drivers (see _widen_plan)."""

    def make():
        p = F1Predictor(
            cache_dir=tmp_path,
            backend=SyntheticBackend(seed=5, n_events=n_events),
        )
        orig = p.prepare_weekend
        state = {"i": 0}

        def prepare(season, race, **kw):
            plan = orig(season, race, **kw)
            w = widths[state["i"] % len(widths)]
            state["i"] += 1
            return _widen_plan(plan, w)

        p.prepare_weekend = prepare
        return p

    return make


@pytest.mark.slow
def test_batched_backtest_mixed_field_widths(tmp_path):
    """A season whose races have 40 and 20 drivers runs as one batch (the
    narrow race padded to the widest field, parallel/sharded.py) and
    returns valid metrics."""
    from monte_carlo_gp.validate.backtest import backtest_model_batched

    res = backtest_model_batched(
        _widening_factory(tmp_path, [40, 20]), [2024], seed=4,
        n_simulations=256, verbose=False,
    )
    assert res["n_races"] == 2
    assert 0.0 <= res["pole_brier"] <= 1.0
    assert 0.0 <= res["win_brier"] <= 1.0


@pytest.mark.slow
def test_alt_quali_models_beat_elo_pole_brier(tmp_path):
    """CI lock for the quali head-to-head headline (PARITY 'Quali-model
    head-to-head'; VERDICT r4 #4): the design-doc alt models' reason to
    exist is pole accuracy (reference plan.md:1111-1213), so a silent
    predictive regression in either must fail the suite, not just their
    convergence diagnostics.

    Pole Brier is simulation-free (quali model only — see
    test_batched_backtest_matches_sequential), so a tiny Monte Carlo count
    keeps this a quali-model measurement. The harness is the PARITY one:
    the default synthetic world (seed 2718) over the full 20-race calendar
    — measured here: elo 0.0496, gbm 0.0091, bayesian 0.0035 (the reduced
    300+300 HMC budget reproduces the full-budget headline)."""
    n_events = 20

    def factory(quali_model, bayes_budget=None):
        cache = tmp_path / quali_model

        def make():
            p = F1Predictor(
                cache_dir=cache,
                backend=SyntheticBackend(seed=2718),
                engine="xla",
                quali_model=quali_model,
            )
            if bayes_budget is not None:
                from monte_carlo_gp.models.bayesian import (
                    BayesianQualiModel,
                )

                p._bayes_model = BayesianQualiModel(**bayes_budget)
            return p

        return make

    common = dict(seed=42, n_simulations=64, verbose=False)
    elo = backtest_model(factory("elo"), [2024], **common)
    gbm = backtest_model(factory("gbm"), [2024], **common)
    bay = backtest_model(
        factory("bayesian",
                bayes_budget=dict(num_warmup=300, num_samples=300)),
        [2024], **common,
    )
    assert elo["n_races"] == gbm["n_races"] == bay["n_races"] == n_events

    # Absolute gates (chance = 0.0475; elo parity ~0.05 on this world).
    assert gbm["pole_brier"] < 0.02, gbm["pole_brier"]
    assert bay["pole_brier"] < 0.02, bay["pole_brier"]
    # Relative gates: the learned models must beat the Elo grid clearly.
    assert gbm["pole_brier"] < 0.5 * elo["pole_brier"], (
        gbm["pole_brier"], elo["pole_brier"])
    assert bay["pole_brier"] < 0.5 * elo["pole_brier"], (
        bay["pole_brier"], elo["pole_brier"])


def test_checkpoint_resume_tolerates_truncated_trailing_line(tmp_path):
    """A run killed mid-append leaves a partial JSONL line; resume must
    skip it (that race re-runs) instead of refusing to start."""
    full = backtest_model(
        _factory(tmp_path, n_events=3), [2024], seed=42, n_simulations=256,
        verbose=False,
    )
    ckpt = tmp_path / "trunc.jsonl"
    full_ckpt = tmp_path / "full2.jsonl"
    backtest_model(
        _factory(tmp_path, n_events=3), [2024], seed=42, n_simulations=256,
        checkpoint_path=full_ckpt, verbose=False,
    )
    lines = full_ckpt.read_text().splitlines()
    # first race intact + second race truncated mid-record
    ckpt.write_text(lines[0] + "\n" + lines[1][: len(lines[1]) // 2] + "\n")
    resumed = backtest_model(
        _factory(tmp_path, n_events=3), [2024], seed=42, n_simulations=256,
        checkpoint_path=ckpt, verbose=False,
    )
    assert resumed["n_races"] == 3
    assert resumed["pole_brier"] == pytest.approx(full["pole_brier"], abs=1e-9)
    assert resumed["win_brier"] == pytest.approx(full["win_brier"], abs=1e-9)


@pytest.mark.slow
def test_checkpoint_resume_matches_with_rookie_prior(tmp_path):
    """rookie_prior=True resume must reproduce the uninterrupted run: the
    replay re-seeds checkpointed races' rookies (teammate priors) before
    applying their actual updates, mirroring prepare_weekend's order."""

    def factory():
        return F1Predictor(
            cache_dir=tmp_path,
            backend=SyntheticBackend(seed=5, n_events=3),
            rookie_prior=True,
        )

    full = backtest_model(
        factory, [2024], seed=42, n_simulations=256, verbose=False,
    )
    full_ckpt = tmp_path / "rk_full.jsonl"
    backtest_model(
        factory, [2024], seed=42, n_simulations=256,
        checkpoint_path=full_ckpt, verbose=False,
    )
    ckpt = tmp_path / "rk_partial.jsonl"
    ckpt.write_text(full_ckpt.read_text().splitlines()[0] + "\n")
    resumed = backtest_model(
        factory, [2024], seed=42, n_simulations=256,
        checkpoint_path=ckpt, verbose=False,
    )
    assert resumed["pole_brier"] == pytest.approx(full["pole_brier"], abs=1e-9)
    assert resumed["win_brier"] == pytest.approx(full["win_brier"], abs=1e-9)
