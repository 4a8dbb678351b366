"""Bayesian hierarchical quali model (models/bayesian.py).

The reference's design doc sketches this model with PyMC ("Approach B",
/root/reference/plan.md:1111-1175) but never ships it. These tests pin our
pure-JAX HMC implementation: design-matrix semantics, posterior recovery on
data generated FROM the model, convergence (split-R̂ across vmapped chains),
bitwise seed determinism, posterior-predictive grid probabilities, the
archive-token fit cache, and the predictor's opt-in path with Elo fallback.
"""

import numpy as np
import pandas as pd
import pytest

from monte_carlo_gp.models import bayesian as B

# ------------------------------------------------------------ fixtures

TEAMS = [f"T{i}" for i in range(5)]
DRIVERS = [f"D{i}" for i in range(10)]
CIRCUITS = [f"C{i}" for i in range(6)]
TEAM_OF = {d: TEAMS[i // 2] for i, d in enumerate(DRIVERS)}


def _world(seed=0, laps_per=8, noise=0.08):
    """Synthetic lap archive generated from the model's own generative
    story (known effects → recovery is checkable)."""
    rng = np.random.default_rng(seed)
    true_team = rng.normal(0.5, 0.4, len(TEAMS))
    true_driver = rng.normal(0.0, 0.25, len(DRIVERS))
    true_circuit = rng.normal(0.0, 0.15, len(CIRCUITS))
    rows = []
    for c_i, c in enumerate(CIRCUITS):
        for d_i, d in enumerate(DRIVERS):
            mu = (
                true_team[TEAMS.index(TEAM_OF[d])]
                + true_driver[d_i]
                + true_circuit[c_i]
            )
            for _ in range(laps_per):
                gap = max(0.0, mu + rng.normal(0.0, noise))
                rows.append(
                    dict(
                        Driver=d,
                        Team=TEAM_OF[d],
                        circuit=c,
                        LapTime=80.0 * (1.0 + gap / 100.0),
                        session_type="Q",
                    )
                )
    truth = {
        "team": true_team,
        "driver": true_driver,
        "circuit": true_circuit,
        "total": np.array(
            [
                true_team[TEAMS.index(TEAM_OF[d])] + true_driver[i]
                for i, d in enumerate(DRIVERS)
            ]
        ),
    }
    return pd.DataFrame(rows), truth


@pytest.fixture(scope="module")
def world():
    return _world()


@pytest.fixture(scope="module")
def posterior(world):
    laps, _ = world
    design = B.build_quali_design(laps)
    return B.sample_posterior(design, num_warmup=1000, num_samples=1000, seed=1)


# ------------------------------------------------------------ design matrix


def test_design_gap_is_percent_to_circuit_fastest():
    laps = pd.DataFrame(
        dict(
            Driver=["A", "B", "A", "B"],
            Team=["X", "Y", "X", "Y"],
            circuit=["c1", "c1", "c2", "c2"],
            LapTime=[80.0, 81.0, 90.0, 91.8],
        )
    )
    d = B.build_quali_design(laps, session_type=None)
    # fastest per circuit gets gap 0; others (lap-min)/min*100
    np.testing.assert_allclose(d.y, [0.0, 1.25, 0.0, 2.0], rtol=1e-6)
    assert d.teams == ("X", "Y") and d.drivers == ("A", "B")
    assert d.circuits == ("c1", "c2")
    assert d.team_idx.tolist() == [0, 1, 0, 1]


def test_design_drops_nan_and_filters_session(world):
    laps, _ = world
    spiked = pd.concat(
        [
            laps,
            pd.DataFrame(
                dict(
                    Driver=["Z", "D0"],
                    Team=["T0", "T0"],
                    circuit=["C0", "C0"],
                    LapTime=[np.nan, 70.0],
                    session_type=["Q", "R"],  # R row filtered by default
                )
            ),
        ],
        ignore_index=True,
    )
    d = B.build_quali_design(spiked)
    assert d.n_rows == len(laps)  # NaN row and R row both excluded
    assert "Z" not in d.drivers


def test_design_raises_on_empty():
    with pytest.raises(ValueError, match="No valid lap times"):
        B.build_quali_design(pd.DataFrame())
    with pytest.raises(ValueError, match="No valid lap times"):
        B.build_quali_design(
            pd.DataFrame(
                dict(Driver=["A"], Team=["X"], circuit=["c"], LapTime=[np.nan])
            )
        )


def test_design_refuses_race_only_archive():
    """An archive WITH a session_type column but ZERO 'Q' rows must raise —
    never silently fit the qualifying model on race laps (the predictor
    wrapper degrades the raise to the Elo path). Shared strict filter:
    models/quali_common.valid_q_rows, used by ml.py too."""
    race_only = pd.DataFrame(
        dict(
            Driver=["A", "B"],
            Team=["X", "Y"],
            circuit=["c1", "c1"],
            LapTime=[92.0, 93.0],
            session_type=["R", "R"],
        )
    )
    with pytest.raises(ValueError, match="no 'Q' session laps"):
        B.build_quali_design(race_only)
    from monte_carlo_gp.models import ml as M

    with pytest.raises(ValueError, match="no 'Q' session laps"):
        M.build_training_frame(race_only)
    # session_type=None still trains on everything (the sketch's behavior).
    assert B.build_quali_design(race_only, session_type=None).n_rows == 2


# ------------------------------------------------------------ inference


def test_posterior_recovers_generating_effects(world, posterior):
    _, truth = world
    d = posterior.design
    # Per-driver total pace (team + driver effect) against the generating
    # values: identified up to a common shift by gap-to-fastest, so compare
    # by correlation.
    pred = np.array(
        [
            posterior.team_effect[:, d.teams.index(TEAM_OF[drv])].mean()
            + posterior.driver_effect[:, d.drivers.index(drv)].mean()
            for drv in DRIVERS
        ]
    )
    corr = np.corrcoef(pred, truth["total"])[0, 1]
    assert corr > 0.95
    # Observation sigma recovered (generating noise 0.08 gap-percent,
    # truncation at 0 biases it slightly low).
    assert 0.04 < float(posterior.sigma.mean()) < 0.16


def test_chains_converge(posterior):
    rhat = B.split_rhat(posterior.raw)
    assert float(rhat.max()) < 1.15
    # Dual averaging should land acceptance near the 0.8 target.
    assert np.all(posterior.accept_rate > 0.6)
    assert np.all(posterior.accept_rate < 0.99)


def test_same_seed_bitwise_identical(world):
    laps, _ = world
    design = B.build_quali_design(laps)
    a = B.sample_posterior(design, num_warmup=100, num_samples=50, seed=7)
    b = B.sample_posterior(design, num_warmup=100, num_samples=50, seed=7)
    c = B.sample_posterior(design, num_warmup=100, num_samples=50, seed=8)
    assert np.array_equal(a.raw, b.raw)
    assert not np.array_equal(a.raw, c.raw)


# ------------------------------------------------------------ grid probabilities


def test_position_probs_are_distributions(posterior):
    probs = B.quali_position_probs(posterior, DRIVERS, TEAM_OF, "C0", seed=3)
    arr = np.array([probs[d] for d in DRIVERS])
    assert arr.shape == (len(DRIVERS), len(DRIVERS))
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-9)
    np.testing.assert_allclose(arr.sum(axis=0), 1.0, atol=1e-9)  # doubly stochastic
    assert (arr >= 0).all()


def test_fastest_driver_most_likely_on_pole(world, posterior):
    laps, _ = world
    probs = B.quali_position_probs(posterior, DRIVERS, TEAM_OF, "C0", seed=3)
    # "Best" judged from the observed data the model was fitted on (the
    # generator truncates gaps at 0, so pre-truncation effects can reorder
    # near-tied drivers): lowest mean observed gap across circuits.
    fastest = laps.groupby("circuit")["LapTime"].transform("min")
    gap = (laps["LapTime"] - fastest) / fastest * 100.0
    ranked = gap.groupby(laps["Driver"]).mean().sort_values()
    pole = {d: probs[d][0] for d in DRIVERS}
    # With this seed the data's top two drivers are statistically tied
    # (mean gaps 0.0279 vs 0.0283), so pin the pair, not the argmax: the
    # favorite is one of them and together they own almost all pole mass.
    top2 = set(ranked.index[:2])
    assert max(pole, key=pole.get) in top2
    assert sum(pole[d] for d in top2) > 0.8


def test_unseen_driver_and_circuit_get_prior_spread(posterior):
    field = DRIVERS + ["ROOKIE"]
    teams = dict(TEAM_OF, ROOKIE="BRAND_NEW_TEAM")
    probs = B.quali_position_probs(
        posterior, field, teams, "UNSEEN_CIRCUIT", seed=3
    )
    arr = np.array([probs[d] for d in field])
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-9)
    r = np.array(probs["ROOKIE"])
    # The rookie draws its effect from the fitted hierarchical prior each
    # posterior draw: its distribution must be spread (not a point mass)...
    assert (r > 0).sum() >= 3
    # ...and centered mid-grid rather than pinned to an extreme.
    expected_pos = float((r * np.arange(len(field))).sum())
    assert 1.0 < expected_pos < len(field) - 2.0


def test_position_probs_seeded(posterior):
    a = B.quali_position_probs(posterior, DRIVERS, TEAM_OF, "C0", seed=3)
    b = B.quali_position_probs(posterior, DRIVERS, TEAM_OF, "C0", seed=3)
    c = B.quali_position_probs(posterior, DRIVERS, TEAM_OF, "C0", seed=4)
    assert a == b
    assert a != c


# ------------------------------------------------------------ fit cache


def test_model_caches_fit_per_archive_token(world):
    laps, _ = world
    laps = laps.copy()
    laps.attrs["_mcgp_loader_token"] = object()
    m = B.BayesianQualiModel(num_warmup=100, num_samples=50)
    p1 = m.posterior_for(laps)
    p2 = m.posterior_for(laps)
    assert p1 is p2  # same archive build → cached
    rebuilt = laps.copy()
    rebuilt.attrs["_mcgp_loader_token"] = object()  # walk-forward rebuild
    p3 = m.posterior_for(rebuilt)
    assert p3 is not p1


def test_model_refits_untokened_frames(world):
    laps, _ = world
    laps = laps.copy()
    laps.attrs.pop("_mcgp_loader_token", None)
    m = B.BayesianQualiModel(num_warmup=100, num_samples=50)
    p1 = m.posterior_for(laps)
    p2 = m.posterior_for(laps)
    assert p2 is not p1  # no token → never trust the cache


# ------------------------------------------------------------ predictor opt-in


def _make_predictor(tmp_path, **kw):
    from monte_carlo_gp.data.synthetic import SyntheticBackend
    from monte_carlo_gp.models.predictor import F1Predictor

    return F1Predictor(
        cache_dir=tmp_path,
        backend=SyntheticBackend(seed=2718),
        engine="xla",
        **kw,
    )


def test_predictor_rejects_unknown_quali_model(tmp_path):
    with pytest.raises(ValueError, match="quali_model"):
        _make_predictor(tmp_path, quali_model="nuts")


@pytest.mark.slow
def test_predictor_bayesian_path_end_to_end(tmp_path):
    p = _make_predictor(tmp_path, quali_model="bayesian")
    # Small budget: the test pins plumbing, not posterior quality.
    p._bayes_model = B.BayesianQualiModel(num_warmup=150, num_samples=100)
    plan = p.prepare_weekend(2024, "Bahrain")
    assert p._bayes_model._posterior is not None  # bayesian path actually ran
    arr = np.array([plan.quali_probs[d] for d in plan.drivers])
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-6)
    # Same weekend re-prepared: cached fit + crc32-keyed noise → identical.
    plan2 = p.prepare_weekend(2024, "Bahrain")
    assert plan.quali_probs == plan2.quali_probs
    # Differs from the Elo quali path.
    pe = _make_predictor(tmp_path, quali_model="elo")
    plan_elo = pe.prepare_weekend(2024, "Bahrain")
    assert plan.quali_probs != plan_elo.quali_probs


def test_predictor_falls_back_to_elo_on_empty_archive(tmp_path):
    p = _make_predictor(tmp_path, quali_model="bayesian")
    p.feature_engine.laps = pd.DataFrame()  # no archive
    assert p._predict_quali_alt(["VER", "NOR"], "Bahrain", 2024) is None
