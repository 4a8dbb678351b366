"""A/B validation against the ACTUAL reference implementation.

Every other correctness test in this suite compares the engine against
builder-written oracles (tests/oracle/*, native/oracle.cpp) — a shared
misreading of the reference would pass all of them. These tests close that
loophole by importing the genuine reference code from /root/reference
(read-only; zero network deps once fastf1 is stubbed) and driving it
head-to-head:

  * engine: `RaceSimulator.run_monte_carlo` (reference simulation.py:59-100)
    vs the XLA engine AND the native C++ oracle — distributional agreement
    (per-driver total variation + mean-finish z) at >=20k reference sims;
  * Elo: `F1EloSystem` (reference elo.py) replayed on identical event
    sequences vs models/elo.py — rating equality (f32 accumulation bound);
  * features: reference `F1FeatureEngine` (features.py) on identical
    archive frames vs models/features.py in reference_compat mode —
    field-by-field equality of all 18 features, plus explicit assertions of
    the three documented default-mode divergences (gap-to-pole stub, dead
    teammate delta, circuit-affinity name matching).

RNG streams necessarily differ (the reference consumes one global
random/np.random stream data-dependently — SURVEY.md §7 "hard parts"), so
engine equality is distributional, not bitwise.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import pytest

REF = Path("/root/reference")

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not REF.exists(), reason="reference tree unavailable"),
]


@pytest.fixture(scope="module")
def ref():
    """Import the reference package with fastf1 stubbed out."""
    sys.modules.setdefault("fastf1", types.ModuleType("fastf1"))
    if str(REF) not in sys.path:
        sys.path.insert(0, str(REF))
    import src.elo as ref_elo
    import src.features as ref_features
    import src.simulation as ref_sim

    return types.SimpleNamespace(sim=ref_sim, elo=ref_elo, features=ref_features)


# =============================================================================
# (a) Engine: reference RaceSimulator vs XLA engine vs native oracle
# =============================================================================


def _drivers(d):
    return [f"D{i:02d}" for i in range(d)]


def _scenario(d, seed=5):
    """Per-driver params exercising pit thresholds (deg above/at/below the
    0.05 and 0.02 branch points), per-driver DNF rates and mixed variance.

    Arrays are kept in FLOAT64: the reference must receive the exact decimal
    values (0.05 must compare `not > 0.05` in its pit logic), while the
    engine/oracle side casts to f32 where 0.05f likewise compares
    `not > 0.05f`. Feeding the reference float(np.float32(0.05)) =
    0.0500000007 would flip its threshold and manufacture a fake divergence
    (see the f32-threshold note in tests/oracle/reference_sim.py:236-241)."""
    rng = np.random.default_rng(seed)
    grid = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 8.0)
    grid /= grid.sum(axis=1, keepdims=True)
    deg_cycle = np.array([0.03, 0.05, 0.08, 0.012, 0.06])
    return dict(
        grid_probs=grid,
        base_pace=90.0 + 0.06 * np.arange(d) + 0.03 * rng.standard_normal(d),
        tire_deg=deg_cycle[np.arange(d) % len(deg_cycle)],
        variance=0.1 + 0.01 * (np.arange(d) % 5),
        dnf_rate=np.linspace(0.0005, 0.002, d),
        team_dnf_rate=np.full(d, 0.002),
    )


# The reference's two-compound fallback compound comes from `set.pop()`
# (simulation.py:482-488) — a HASH-RANDOMIZED choice: SOFT vs HARD is a
# 1.4 s/lap swing for the rest of the stint, so at a fixed RNG seed the
# reference produces materially different distributions depending on
# PYTHONHASHSEED (test_reference_compound_fallback_is_hash_dependent pins
# this). Our engines fix the choice to HARD (MEDIUM->MEDIUM, remaining>20)
# and MEDIUM (SOFT->SOFT, remaining<=15) — one valid refinement — so the
# A/B runs the reference in a subprocess with a probed matching hash seed.

_POP_PROBE = (
    "d={'SOFT','MEDIUM','HARD'};"
    "print((d-{'MEDIUM'}).pop(),(d-{'SOFT'}).pop())"
)


def _pop_choices(hashseed: str) -> str:
    import os
    import subprocess

    r = subprocess.run(
        [sys.executable, "-c", _POP_PROBE],
        env={**os.environ, "PYTHONHASHSEED": hashseed},
        capture_output=True,
        text=True,
        check=True,
    )
    return r.stdout.strip()


@pytest.fixture(scope="module")
def matching_hashseed():
    """A PYTHONHASHSEED under which the reference's set.pop() reproduces the
    engines' fixed compound refinement (HARD, MEDIUM)."""
    for seed in range(32):
        if _pop_choices(str(seed)) == "HARD MEDIUM":
            return str(seed)
    pytest.skip("no PYTHONHASHSEED in [0,32) reproduces the HARD/MEDIUM refinement")


def _run_reference(
    sc, laps, n_sims, seed, hashseed, tmpdir, track_condition="dry",
    pit_loss=21.0, overtake_delta=0.6, sc_p=0.01, vsc_p=0.015, red_p=0.002,
    n_procs=1,
):
    """Drive the genuine reference engine in hash-pinned subprocesses.

    `n_procs` > 1 shards `n_sims` over that many runner subprocesses with
    distinct derived seeds and averages the finish-probability matrices —
    the reference is a ~180 sims/s serial Python loop, so sharding is what
    makes >=40k-sim tight-tolerance comparisons affordable on multi-core
    machines (they run concurrently up to os.cpu_count(); a single-core CI
    box degrades to sequential with identical results)."""
    import json
    import os
    import subprocess

    from monte_carlo_gp import config as cfg

    d = len(sc["base_pace"])
    assert n_sims % n_procs == 0, (n_sims, n_procs)
    shard_sims = n_sims // n_procs
    runner = Path(__file__).parent / "ref_engine_runner.py"
    env = {**os.environ, "PYTHONHASHSEED": hashseed}
    max_conc = max(1, min(n_procs, os.cpu_count() or 1))

    jobs = []
    for shard in range(n_procs):
        in_path = Path(tmpdir) / f"ref_in_{shard}.npz"
        out_path = Path(tmpdir) / f"ref_out_{shard}.npy"
        meta = dict(
            d=d, laps=laps, n_sims=shard_sims,
            seed=seed if n_procs == 1 else seed + 104729 * (shard + 1),
            track_condition=track_condition, pit_loss=pit_loss,
            overtake_delta=overtake_delta, sc_p=sc_p, vsc_p=vsc_p, red_p=red_p,
            tire_compounds={k: dict(v) for k, v in cfg.TIRE_COMPOUNDS.items()},
        )
        np.savez(
            in_path,
            meta_json=json.dumps(meta),
            grid_probs=np.asarray(sc["grid_probs"], np.float64),
            base_pace=np.asarray(sc["base_pace"], np.float64),
            tire_deg=np.asarray(sc["tire_deg"], np.float64),
            variance=np.asarray(sc["variance"], np.float64),
            dnf_rate=np.asarray(sc["dnf_rate"], np.float64),
        )
        jobs.append((in_path, out_path))

    running: list[tuple[subprocess.Popen, Path]] = []
    results = []

    def _drain(block_all=False):
        while running and (block_all or len(running) >= max_conc):
            proc, out_path = running.pop(0)
            stdout, stderr = proc.communicate()
            assert proc.returncode == 0, (proc.returncode, stderr[-2000:])
            results.append(np.load(out_path))

    for in_path, out_path in jobs:
        _drain()
        proc = subprocess.Popen(
            [sys.executable, str(runner), str(in_path), str(out_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        running.append((proc, out_path))
    _drain(block_all=True)
    return np.mean(results, axis=0)  # equal shard sizes -> plain mean


def _compare(ref_probs, probs, n_ref, n_ours, tv_bound, z_bound=4.5):
    d = ref_probs.shape[0]
    tv = 0.5 * np.abs(ref_probs - probs).sum(axis=1)
    assert tv.max() < tv_bound, ("per-driver TV", tv)
    positions = np.arange(1, d + 1)
    mean_r, mean_o = ref_probs @ positions, probs @ positions
    var_r = ref_probs @ positions**2 - mean_r**2
    var_o = probs @ positions**2 - mean_o**2
    se = np.sqrt(var_r / n_ref + var_o / n_ours)
    z = (mean_r - mean_o) / np.maximum(se, 1e-6)
    assert (np.abs(z) < z_bound).all(), ("mean-finish z", mean_r, mean_o, z)


def test_reference_compound_fallback_is_hash_dependent():
    """Pin the A/B premise: the reference's two-compound fallback compound
    (set.pop, simulation.py:482-488) varies with PYTHONHASHSEED, and the
    engines' fixed HARD/MEDIUM choice is reachable. If CPython's hashing
    ever changes such that only one outcome exists, the subprocess pinning
    can be retired."""
    seen = {_pop_choices(str(s)) for s in range(16)}
    assert "HARD MEDIUM" in {c for c in seen}, seen
    first_words = {c.split()[0] for c in seen}
    assert first_words == {"HARD", "SOFT"}, (
        "expected the MEDIUM->MEDIUM fallback to be hash-dependent", seen
    )


def test_reference_engine_vs_xla_and_native_20drv_57laps(
    ref, matching_hashseed, tmp_path
):
    """The headline A/B: full-size race, >=20k genuine reference sims."""
    import jax

    from monte_carlo_gp.config import make_sim_params
    from monte_carlo_gp.ops.engine import run_monte_carlo
    from monte_carlo_gp.validate.native_oracle import available, run_native_oracle

    d, laps = 20, 57
    sc = _scenario(d)
    n_ref = 20_000
    ref_probs = _run_reference(sc, laps, n_ref, 42, matching_hashseed, tmp_path)

    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, **sc)
    n_xla = 32_768  # CI machine is single-core; ref-side (20k) noise dominates
    xla = np.asarray(run_monte_carlo(params, jax.random.PRNGKey(42), n_xla, laps))
    _compare(ref_probs, xla, n_ref, n_xla, tv_bound=0.03)

    if available():
        # measured agreement at these sizes: max TV ~0.014 (MC noise)
        n_nat = 262_144
        native = run_native_oracle(params, seed=42, n_sims=n_nat, total_laps=laps)
        _compare(ref_probs, native, n_ref, n_nat, tv_bound=0.025)


def test_reference_engine_vs_native_tight(ref, matching_hashseed, tmp_path):
    """Tight genuine-reference link at native-oracle resolution (the round-2
    suite's tight bounds all rested on the builder-written C++ oracle; the
    genuine article only confirmed at TV 0.03). 40,960 REAL reference sims
    (8 sharded hash-pinned subprocesses) vs 393,216 native-oracle sims:
    combined MC noise floor is sqrt(1/40960 + 1/393216) ~ 0.0052 per cell,
    observed max per-driver TV 0.0104 (mean 0.0061); the 0.015 bound is
    <=2x the per-cell floor and ~1.5x the observed max, so the genuine
    reference itself now pins the event model at the resolution the oracle
    tests use."""
    from monte_carlo_gp.config import make_sim_params
    from monte_carlo_gp.validate.native_oracle import available, run_native_oracle

    if not available():
        pytest.skip("native oracle unavailable (g++)")
    d, laps = 20, 57
    sc = _scenario(d)
    n_ref = 40_960
    ref_probs = _run_reference(
        sc, laps, n_ref, 42, matching_hashseed, tmp_path, n_procs=8
    )
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, **sc)
    n_nat = 393_216
    native = run_native_oracle(params, seed=11, n_sims=n_nat, total_laps=laps)
    tv = 0.5 * np.abs(ref_probs - native).sum(axis=1)
    print(f"[tight A/B] max per-driver TV: {tv.max():.4f} (mean {tv.mean():.4f})")
    _compare(ref_probs, native, n_ref, n_nat, tv_bound=0.015)


def _stress_native(sc, params, ref_probs, n_ref, laps):
    """Stress-scenario tight side: 131,072 native-oracle sims against the
    sharded 24k genuine-reference run (combined noise ~0.007 per cell at
    d=10; 0.025 is ~2.5x the observed max TV)."""
    from monte_carlo_gp.validate.native_oracle import available, run_native_oracle

    if not available():
        return
    native = run_native_oracle(params, seed=23, n_sims=131_072, total_laps=laps)
    tv = 0.5 * np.abs(ref_probs - native).sum(axis=1)
    print(f"[stress tight A/B] max per-driver TV: {tv.max():.4f}")
    _compare(ref_probs, native, n_ref, 131_072, tv_bound=0.025)


def test_reference_engine_event_heavy(ref, matching_hashseed, tmp_path):
    """SC/VSC/red-flag handlers dominate: ~4 events per race."""
    import jax

    from monte_carlo_gp.config import make_sim_params
    from monte_carlo_gp.ops.engine import run_monte_carlo

    d, laps = 10, 30
    sc = _scenario(d, seed=9)
    n_ref = 24_000
    ref_probs = _run_reference(
        sc, laps, n_ref, 7, matching_hashseed, tmp_path,
        sc_p=0.08, vsc_p=0.1, red_p=0.01, n_procs=8,
    )
    params = make_sim_params(
        pit_loss=21.0, overtake_delta=0.6,
        sc_prob=0.08, vsc_prob=0.1, red_flag_prob=0.01, **sc,
    )
    n_xla = 32_768
    xla = np.asarray(run_monte_carlo(params, jax.random.PRNGKey(7), n_xla, laps))
    _compare(ref_probs, xla, n_ref, n_xla, tv_bound=0.04)
    _stress_native(sc, params, ref_probs, n_ref, laps)


def test_reference_engine_damp(ref, matching_hashseed, tmp_path):
    """Intermediate tires, wet pit picks, no two-compound rule."""
    import jax

    from monte_carlo_gp.config import make_sim_params
    from monte_carlo_gp.ops.engine import run_monte_carlo

    d, laps = 10, 30
    sc = _scenario(d, seed=13)
    n_ref = 24_000
    ref_probs = _run_reference(
        sc, laps, n_ref, 5, matching_hashseed, tmp_path, track_condition="damp",
        n_procs=8,
    )
    params = make_sim_params(
        pit_loss=21.0, overtake_delta=0.6, track_condition="damp", **sc
    )
    n_xla = 32_768
    xla = np.asarray(run_monte_carlo(params, jax.random.PRNGKey(5), n_xla, laps))
    _compare(ref_probs, xla, n_ref, n_xla, tv_bound=0.04)
    _stress_native(sc, params, ref_probs, n_ref, laps)


def test_reference_engine_full_wet(ref, matching_hashseed, tmp_path):
    """Full-wet: WET compound start, wet pit picks, fresh tires for all."""
    import jax

    from monte_carlo_gp.config import make_sim_params
    from monte_carlo_gp.ops.engine import run_monte_carlo

    d, laps = 10, 30
    sc = _scenario(d, seed=21)
    n_ref = 24_000
    ref_probs = _run_reference(
        sc, laps, n_ref, 9, matching_hashseed, tmp_path, track_condition="wet",
        n_procs=8,
    )
    params = make_sim_params(
        pit_loss=21.0, overtake_delta=0.6, track_condition="wet", **sc
    )
    n_xla = 32_768
    xla = np.asarray(run_monte_carlo(params, jax.random.PRNGKey(9), n_xla, laps))
    _compare(ref_probs, xla, n_ref, n_xla, tv_bound=0.04)
    _stress_native(sc, params, ref_probs, n_ref, laps)


# =============================================================================
# (b) Elo: reference F1EloSystem vs models/elo.py on identical sequences
# =============================================================================


def _random_events(seed, n_events=60):
    """Chronological mixed event stream with subsets, ties and recency
    changes — the exact same sequence is fed to both systems."""
    rng = np.random.default_rng(seed)
    names = _drivers(20)
    events = []
    for i in range(n_events):
        k = int(rng.integers(2, 21))
        field = list(rng.choice(names, size=k, replace=False))
        if rng.random() < 0.5:  # quali: lap times, occasional exact ties
            vals = np.round(rng.uniform(88.0, 95.0, k), 2)
            if k > 3 and rng.random() < 0.3:
                vals[1] = vals[0]  # tie
            events.append(("quali", list(zip(field, vals.tolist())), i))
        else:  # race: positions (ties impossible in real data, add one anyway)
            pos = list(rng.permutation(np.arange(1, k + 1)))
            events.append(("race", list(zip(field, [int(p) for p in pos])), i))
    return events


def test_reference_elo_exact_replay(ref):
    from monte_carlo_gp.models.elo import F1EloSystem

    ref_sys = ref.elo.F1EloSystem()
    ours = F1EloSystem()
    events = _random_events(3)
    total = len(events)
    for kind, results, idx in events:
        years_ago = [0, 0, 1, 2, 3][idx % 5]
        ref_sys.set_recency_weight(years_ago, race_index=idx, total_races=total)
        ours.set_recency_weight(years_ago, race_index=idx, total_races=total)
        if kind == "quali":
            ref_sys.update_quali_ratings(results)
            ours.update_quali_ratings(results)
        else:
            ref_sys.update_race_ratings(results)
            ours.update_race_ratings(results)

    ours.flush()
    for name in _drivers(20):
        for disc in ("quali", "race"):
            r_ref = ref_sys.get_rating(name, disc)
            r_ours = ours.get_rating(name, disc)
            # ours accumulates in float32; 60 events of K<=48
            # deltas bound the rounding drift far below any formula error.
            assert abs(r_ref - r_ours) < 0.05, (name, disc, r_ref, r_ours)

    # softmax pole probabilities must agree too (elo.py:124-141)
    p_ref = ref_sys.predict_quali_probs(_drivers(20))
    p_ours = ours.predict_quali_probs(_drivers(20))
    for name in _drivers(20):
        assert p_ref[name] == pytest.approx(p_ours[name], rel=1e-3, abs=1e-6)


def test_reference_elo_single_event_tight(ref):
    """One event, fresh ratings: agreement limited only by f32 rounding."""
    from monte_carlo_gp.models.elo import F1EloSystem

    ref_sys = ref.elo.F1EloSystem()
    ours = F1EloSystem()
    results = [("A", 90.0), ("B", 90.0), ("C", 91.5), ("D", 89.2)]  # tie A=B
    ref_sys.update_quali_ratings(results)
    ours.update_quali_ratings(results)
    for name in "ABCD":
        assert ours.get_rating(name, "quali") == pytest.approx(
            ref_sys.get_rating(name, "quali"), abs=1e-3
        )


def test_reference_elo_ordered_list_raises_like_backtest(ref):
    """The reference defect our backtest fixes: ordered abbreviation lists
    raise inside the reference's tuple unpacking (validation.py:191-199 ⚠).
    Pin that behavior so the compat flag's premise stays true."""
    ref_sys = ref.elo.F1EloSystem()
    with pytest.raises((ValueError, TypeError)):
        ref_sys.update_quali_ratings(["VER", "NOR", "LEC"])


# =============================================================================
# (c) Features: reference F1FeatureEngine vs models/features.py
# =============================================================================


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """One shared synthetic archive (2 seasons, includes wet events), loaded
    through OUR loader, then injected verbatim into both feature engines."""
    from monte_carlo_gp.data.loader import F1DataLoader
    from monte_carlo_gp.data.synthetic import SyntheticBackend
    from monte_carlo_gp.models.features import F1FeatureEngine

    loader = F1DataLoader(
        cache_dir=tmp_path_factory.mktemp("ab_cache"),
        backend=SyntheticBackend(seed=5, n_events=12),  # includes Belgium (wet)
    )
    ours = F1FeatureEngine(loader, reference_compat=True)
    ours.load_historical_data([2023, 2024])
    return ours


def test_reference_features_field_by_field(ref, archives):
    """All 18 features, every driver, dry and wet weather, multiple
    circuits: the reference engine on the same frames must agree exactly
    (rel 1e-9) with our reference_compat mode."""
    ours = archives
    ref_engine = ref.features.F1FeatureEngine(data_loader=None)
    ref_engine.laps = ours.laps.copy()
    ref_engine.race_results = ours.race_results.copy()

    from monte_carlo_gp import config as cfg

    drivers = list(cfg.DRIVER_TEAMS.keys())
    weathers = [
        {"rainfall": False, "track_temp": 38.0},
        {"rainfall": True, "track_temp": 22.0},
    ]
    mismatches = []
    for driver in drivers:
        for circuit in ("Bahrain", "Monaco", "Belgium"):
            q_ref = ref_engine.calculate_quali_features(driver, circuit)
            q_ours = ours.calculate_quali_features(driver, circuit)
            assert set(q_ref) == set(q_ours)
            for k in q_ref:
                if q_ours[k] != pytest.approx(q_ref[k], rel=1e-9, abs=1e-12):
                    mismatches.append((driver, circuit, k, q_ref[k], q_ours[k]))
        for weather in weathers:
            r_ref = ref_engine.calculate_race_features(driver, "Bahrain", weather)
            r_ours = ours.calculate_race_features(driver, "Bahrain", weather)
            assert set(r_ref) == set(r_ours)
            for k in r_ref:
                if r_ours[k] != pytest.approx(r_ref[k], rel=1e-9, abs=1e-12):
                    mismatches.append((driver, weather["rainfall"], k, r_ref[k], r_ours[k]))
    assert not mismatches, mismatches[:10]


def test_default_mode_divergences_are_exactly_the_documented_ones(ref, archives):
    """In default (non-compat) mode exactly three quali features may diverge
    from the reference — the documented deliberate fixes — and all race
    features must still match."""
    from monte_carlo_gp.models.features import F1FeatureEngine

    compat = archives
    default = F1FeatureEngine(compat.loader)
    default.laps = compat.laps
    default.race_results = compat.race_results

    ref_engine = ref.features.F1FeatureEngine(data_loader=None)
    ref_engine.laps = compat.laps.copy()
    ref_engine.race_results = compat.race_results.copy()

    fixed_keys = {"avg_gap_to_pole_pct", "teammate_delta", "circuit_affinity"}
    saw_divergence = set()
    from monte_carlo_gp import config as cfg

    for driver in list(cfg.DRIVER_TEAMS.keys())[:8]:
        q_ref = ref_engine.calculate_quali_features(driver, "Bahrain")
        q_def = default.calculate_quali_features(driver, "Bahrain")
        for k in q_ref:
            if q_def[k] != pytest.approx(q_ref[k], rel=1e-9, abs=1e-12):
                assert k in fixed_keys, (driver, k, q_ref[k], q_def[k])
                saw_divergence.add(k)
        r_ref = ref_engine.calculate_race_features(
            driver, "Bahrain", {"rainfall": False, "track_temp": 38.0}
        )
        r_def = default.calculate_race_features(
            driver, "Bahrain", {"rainfall": False, "track_temp": 38.0}
        )
        for k in r_ref:
            assert r_def[k] == pytest.approx(r_ref[k], rel=1e-9, abs=1e-12), (driver, k)
    # the fixes actually change values on this archive
    assert saw_divergence == fixed_keys, saw_divergence


# =============================================================================
# (d) Predictor: the full reference predict_weekend pipeline, head-to-head
# =============================================================================


def test_reference_predictor_end_to_end(ref, tmp_path_factory):
    """Drive the GENUINE reference F1Predictor.predict_weekend
    (reference predictor.py:99-319) on the synthetic world and compare the
    exact simulation inputs it hands to RaceSimulator.run_monte_carlo —
    grid probabilities, adjusted base pace, tire deg, shaped variance,
    per-lap DNF rates, race config, track condition — against OUR
    prepare_weekend's WeekendPlan/SimParams for the same data. These inputs
    are deterministic functions of the data (no Monte Carlo noise), so this
    closes the last A/B gap: the orchestration layer itself (Elo build
    order + recency, FP fallback chains, practice extraction, variance
    shaping, team-trend and wet-skill pace adjustments).

    The reference gets OUR loader duck-typed in (the data-layer APIs are
    parity by construction: load_session / load_season_data / get_weather)
    plus a minimal fastf1 stub for the two direct calls its feature engine
    makes (get_event_schedule / get_session(...).results). Monte Carlo then
    runs at reduced n for a loose end-to-end sanity check on win
    probabilities."""
    import random

    import pandas as pd

    from monte_carlo_gp import config as cfg
    from monte_carlo_gp.data.loader import F1DataLoader as OurLoader
    from monte_carlo_gp.data.synthetic import SyntheticBackend
    from monte_carlo_gp.models.features import F1FeatureEngine as OurFeatures
    from monte_carlo_gp.models.predictor import F1Predictor as OurPredictor

    import src.predictor as ref_predictor_mod

    backend = SyntheticBackend(seed=5, n_events=12)
    loader = OurLoader(
        cache_dir=tmp_path_factory.mktemp("ab_pred_cache"), backend=backend
    )

    # --- minimal fastf1 stub for the reference feature engine -------------
    fake = types.ModuleType("fastf1")
    fake.get_event_schedule = lambda season: pd.DataFrame(backend.get_schedule(season))

    class _RefSession:
        def __init__(self, season, event):
            self.results = backend.load_results(season, event, "R")

        def load(self):
            pass

    fake.get_session = lambda season, event, kind: _RefSession(season, event)

    # The reference F1Predictor constructs its own F1DataLoader, whose
    # __init__ calls fastf1.Cache.enable_cache before we can swap the
    # loader out — give the bare stub module just enough to pass.
    import src.data_loader as ref_loader_mod

    class _Cache:
        @staticmethod
        def enable_cache(path):
            pass

    ref_loader_mod.fastf1.Cache = _Cache

    ref_pred = ref_predictor_mod.F1Predictor()
    ref_pred.data_loader = loader
    ref_pred.feature_engine = ref.features.F1FeatureEngine(loader)

    ours = OurPredictor(
        cache_dir=tmp_path_factory.mktemp("ab_pred_cache2"),
        backend=SyntheticBackend(seed=5, n_events=12),
        engine="xla",
    )
    ours.feature_engine = OurFeatures(ours.data_loader, reference_compat=True)

    captured = {}
    orig_mc = ref.sim.RaceSimulator.run_monte_carlo

    def capture_mc(self, n_simulations, grid_probs, base_pace, tire_deg,
                   driver_variance, driver_dnf_rates=None, seed=None,
                   track_condition="dry"):
        captured.update(
            config=self.config,
            grid_probs={d: list(v) for d, v in grid_probs.items()},
            base_pace=dict(base_pace),
            tire_deg=dict(tire_deg),
            variance=dict(driver_variance),
            dnf=dict(driver_dnf_rates or {}),
            track_condition=track_condition,
        )
        return orig_mc(
            self, 4096, grid_probs, base_pace, tire_deg, driver_variance,
            driver_dnf_rates, seed=7, track_condition=track_condition,
        )

    old_fastf1 = ref.features.fastf1
    old_mc = ref.sim.RaceSimulator.run_monte_carlo
    ref.features.fastf1 = fake
    ref.sim.RaceSimulator.run_monte_carlo = capture_mc
    try:
        for race, expect_cond in (("Bahrain", "dry"), ("Belgium", "damp")):
            random.seed(7)
            np.random.seed(7)
            result_ref = ref_pred.predict_weekend(2024, race, prediction_point="fp2")
            plan = ours.prepare_weekend(2024, race, prediction_point="fp2")

            # --- deterministic simulation inputs --------------------------
            assert captured["track_condition"] == expect_cond, race
            ti = cfg.TRACK_CONDITIONS[
                "damp" if expect_cond == "damp" else "dry"
            ]
            assert int(plan.params.track_condition) == ti

            assert set(captured["base_pace"]) == set(plan.drivers)
            idx = {d: i for i, d in enumerate(plan.drivers)}
            pp = np.asarray(plan.params.base_pace)
            vv = np.asarray(plan.params.variance)
            dd = np.asarray(plan.params.tire_deg)
            nn = np.asarray(plan.params.dnf_rate)
            gg = np.asarray(plan.params.grid_probs)
            mismatches = []
            for d in plan.drivers:
                i = idx[d]
                for name, ref_v, our_v, tol in (
                    ("base_pace", captured["base_pace"][d], pp[i], 1e-3),
                    ("variance", captured["variance"][d], vv[i], 1e-5),
                    ("tire_deg", captured["tire_deg"][d], dd[i], 1e-6),
                    ("dnf", captured["dnf"][d], nn[i], 1e-7),
                ):
                    if abs(ref_v - float(our_v)) > tol:
                        mismatches.append((race, d, name, ref_v, float(our_v)))
                q_ref = np.asarray(captured["grid_probs"][d], float)
                if not np.allclose(gg[i, : len(q_ref)], q_ref, atol=2e-5):
                    mismatches.append((race, d, "grid_probs",
                                       q_ref[:3], gg[i, :3]))
                # pole probability surfaced in the result dict
                if abs(result_ref["pole_probabilities"][d] - plan.quali_probs[d][0]) > 2e-5:
                    mismatches.append((race, d, "pole_prob",
                                       result_ref["pole_probabilities"][d],
                                       plan.quali_probs[d][0]))
            assert not mismatches, mismatches[:8]

            # --- race config ---------------------------------------------
            rc = captured["config"]
            assert rc.total_laps == plan.total_laps
            assert float(plan.params.pit_loss) == pytest.approx(rc.pit_loss)
            assert float(plan.params.overtake_delta) == pytest.approx(rc.overtake_delta)
            assert float(plan.params.drs_delta) == pytest.approx(rc.drs_delta)
            assert float(plan.params.sc_prob) == pytest.approx(rc.sc_probability)
            assert float(plan.params.vsc_prob) == pytest.approx(rc.vsc_probability)
            assert float(plan.params.red_flag_prob) == pytest.approx(rc.red_flag_probability)
            comp_pace = np.asarray(plan.params.compound_pace)
            comp_deg = np.asarray(plan.params.compound_deg)
            for ci, cname in enumerate(cfg.COMPOUND_NAMES):
                info = rc.tire_compounds[cname]
                assert comp_pace[ci] == pytest.approx(info["pace_delta"], abs=1e-5), cname
                assert comp_deg[ci] == pytest.approx(info["deg_rate"], abs=1e-6), cname

            # --- loose end-to-end sanity on win probabilities -------------
            # The reference MC runs IN-PROCESS here, so its set.pop compound
            # fallback depends on this interpreter's hash seed (PARITY.md
            # divergence #1) — exact distributional comparison belongs to
            # the hash-seed-pinned engine A/B above. This check only asserts
            # the two pipelines agree on the broad shape: valid simplex and
            # strongly correlated win probabilities.
            result_ours = ours.assemble_result(
                plan, ours.simulate_plan(plan, 10_240, seed=0)
            )
            w_ref = np.array(
                [result_ref["win_probabilities"][d] for d in plan.drivers]
            )
            w_ours = np.array(
                [result_ours["win_probabilities"][d] for d in plan.drivers]
            )
            assert w_ref.sum() == pytest.approx(1.0, abs=0.02)
            assert w_ours.sum() == pytest.approx(1.0, abs=0.02)
            corr = np.corrcoef(w_ref, w_ours)[0, 1]
            assert corr > 0.9, (race, corr)
    finally:
        ref.features.fastf1 = old_fastf1
        ref.sim.RaceSimulator.run_monte_carlo = old_mc
        if hasattr(ref_loader_mod.fastf1, "Cache"):
            del ref_loader_mod.fastf1.Cache


# =============================================================================
# (e) Backtest harness: the GENUINE reference backtest_model end-to-end
# =============================================================================


def test_reference_backtest_model_end_to_end(ref, tmp_path_factory):
    """Drive the GENUINE reference backtest harness
    (/root/reference/src/validation.py:161-209) — fresh-predictor seasons,
    race walk, swallowed-exception Elo loop, Brier/podium/sklearn-calibration
    scoring — on the synthetic world, and A/B it against OUR backtest_model
    in reference-compat mode. Before this test, the harness layer was the
    only one never driven head-to-head (its metric math was unit-tested
    against hand values only): a shared misreading of race selection, skip
    behavior or calibration binning would have passed the whole suite.

    Two comparison planes:
      1. metric math, EXACT: the reference's scored metrics must equal OUR
         metric functions applied to the reference's own captured
         (predictions, actuals) — identical inputs, so equality is floating-
         point-exact, no MC noise;
      2. harness-level, statistical: our backtest_model with
         reference_compat_elo_noop=True (reproduce the reference's silently
         no-op'd in-season Elo updates, SURVEY.md §3.2 ⚠) and
         pin_clock=False (reproduce its full-season Elo/feature preload) at
         the same sim count must agree on n_races, pole Brier (deterministic
         given data — tight), win Brier / podium accuracy (MC noise —
         statistical), and calibration bin count.
    """
    import random

    import pandas as pd

    import src.data_loader as ref_loader_mod
    import src.predictor as ref_predictor_mod
    import src.validation as ref_val

    from monte_carlo_gp.data.loader import F1DataLoader as OurLoader
    from monte_carlo_gp.data.synthetic import SyntheticBackend
    from monte_carlo_gp.models.features import F1FeatureEngine as OurFeatures
    from monte_carlo_gp.models.predictor import F1Predictor as OurPredictor
    from monte_carlo_gp.validate import backtest as our_backtest
    from monte_carlo_gp.validate import metrics as our_metrics

    # 6 events (Bahrain .. Miami) keep both sprint rounds (China, Miami);
    # the wet path is driven by the predictor A/B above (Belgium, damp).
    # Sized so the serial reference side (~180 sims/s Python MC + pandas
    # feature rescans per race) stays inside a <595 s pytest chunk.
    N_EVENTS = 6
    N_SIMS = 2000
    SEASON = 2024
    backend = SyntheticBackend(seed=5, n_events=N_EVENTS)

    # --- fastf1 stub for the reference's DIRECT calls ---------------------
    # validation.get_races/get_actual_results and features call the module
    # itself: schedule + session results must come from the synthetic world.
    fake = types.ModuleType("fastf1")
    fake.get_event_schedule = lambda season: pd.DataFrame(backend.get_schedule(season))

    class _RefSession:
        def __init__(self, season, event, kind):
            self.results = backend.load_results(season, event, kind)

        def load(self):
            pass

    fake.get_session = lambda season, event, kind: _RefSession(season, event, kind)

    class _Cache:
        @staticmethod
        def enable_cache(path):
            pass

    ref_loader_mod.fastf1.Cache = _Cache

    ref_cache = tmp_path_factory.mktemp("ab_backtest_ref")

    def make_ref_predictor():
        loader = OurLoader(cache_dir=ref_cache, backend=backend)
        p = ref_predictor_mod.F1Predictor()
        p.data_loader = loader
        p.feature_engine = ref.features.F1FeatureEngine(loader)
        # Capture every prediction dict the harness scores (plane 1).
        orig_pw = p.predict_weekend

        def capturing_pw(*a, **k):
            out = orig_pw(*a, **k)
            captured_preds.append(out)
            return out

        p.predict_weekend = capturing_pw
        return p

    captured_preds: list[dict] = []
    captured_acts: list[dict] = []
    orig_gar = ref_val.get_actual_results

    def spy_gar(season, race):
        act = orig_gar(season, race)
        captured_acts.append(act)
        return act

    # Reduced sim count: the reference engine is a ~180 sims/s serial Python
    # loop; 10k sims x 12 races would be ~10 minutes of pure MC.
    orig_mc = ref.sim.RaceSimulator.run_monte_carlo

    def reduced_mc(self, n_simulations, *a, **k):
        return orig_mc(self, N_SIMS, *a, **k)

    old_val_fastf1 = ref_val.fastf1
    old_feat_fastf1 = ref.features.fastf1
    ref_val.fastf1 = fake
    ref.features.fastf1 = fake
    ref_val.get_actual_results = spy_gar
    ref.sim.RaceSimulator.run_monte_carlo = reduced_mc
    try:
        import time as _time

        _t0 = _time.perf_counter()
        random.seed(0)  # backtest_model re-seeds; this just isolates state
        ref_result = ref_val.backtest_model(make_ref_predictor, [SEASON], seed=42)
        print(f"[ab] reference side: {_time.perf_counter() - _t0:.1f}s")
    finally:
        ref_val.fastf1 = old_val_fastf1
        ref.features.fastf1 = old_feat_fastf1
        ref_val.get_actual_results = orig_gar
        ref.sim.RaceSimulator.run_monte_carlo = orig_mc
        if hasattr(ref_loader_mod.fastf1, "Cache"):
            del ref_loader_mod.fastf1.Cache

    # Every synthetic race predicted, none skipped.
    assert ref_result["n_races"] == N_EVENTS
    assert len(captured_preds) == N_EVENTS and len(captured_acts) == N_EVENTS

    # --- plane 1: metric math on IDENTICAL inputs, exact ------------------
    assert our_metrics.brier_score(
        [p["pole_probabilities"] for p in captured_preds],
        [a["pole"] for a in captured_acts],
    ) == pytest.approx(ref_result["pole_brier"], rel=1e-12)
    assert our_metrics.brier_score(
        [p["win_probabilities"] for p in captured_preds],
        [a["winner"] for a in captured_acts],
    ) == pytest.approx(ref_result["win_brier"], rel=1e-12)
    assert our_metrics.podium_accuracy(
        captured_preds, captured_acts
    ) == pytest.approx(ref_result["podium_accuracy"], rel=1e-12)
    our_cal = our_metrics.calibration_analysis(captured_preds, captured_acts)
    assert our_cal["prob_true"] == pytest.approx(
        ref_result["calibration_curve"]["prob_true"], rel=1e-12
    )
    assert our_cal["prob_pred"] == pytest.approx(
        ref_result["calibration_curve"]["prob_pred"], rel=1e-12
    )

    # --- plane 2: our harness end-to-end, reference-compat ----------------
    our_cache = tmp_path_factory.mktemp("ab_backtest_ours")

    def make_our_predictor():
        p = OurPredictor(cache_dir=our_cache, backend=backend, engine="xla")
        p.feature_engine = OurFeatures(p.data_loader, reference_compat=True)
        return p

    _t0 = _time.perf_counter()
    our_result = our_backtest.backtest_model(
        make_our_predictor,
        [SEASON],
        seed=42,
        n_simulations=N_SIMS,
        reference_compat_elo_noop=True,
        pin_clock=False,
        verbose=True,
    )
    print(f"[ab] our side: {_time.perf_counter() - _t0:.1f}s")
    assert our_result["n_races"] == N_EVENTS

    # Pole probabilities are deterministic functions of the data (Elo
    # softmax + feature shaping, no MC), and the feature/predictor A/B
    # proves input equality to ~2e-5 — so pole Brier must agree tightly.
    assert our_result["pole_brier"] == pytest.approx(
        ref_result["pole_brier"], abs=1e-3
    )
    # Win Brier / podium accuracy carry two independent MC runs' noise
    # (plus the reference's hash-seeded compound fallback, PARITY.md #1).
    assert our_result["win_brier"] == pytest.approx(
        ref_result["win_brier"], abs=0.01
    )
    max_podium_flips = 3  # near-tie drivers swapping in/out of top-3
    assert abs(
        our_result["podium_accuracy"] - ref_result["podium_accuracy"]
    ) <= max_podium_flips / (3 * N_EVENTS)
    # Calibration: the binning math is exactly A/B'd in plane 1 on identical
    # inputs. Across two independently-noisy MC runs the only stable
    # observable is the bin POLICY: n_bins = min(10, max(2, n/10)) = 10 at
    # 160 samples on both sides, minus however many bins happen to be empty
    # (sklearn drops them — 2-3 bins of drift between runs is normal).
    for res in (our_result, ref_result):
        curve = res["calibration_curve"]
        assert 2 <= len(curve["prob_pred"]) <= 10
        assert len(curve["prob_true"]) == len(curve["prob_pred"])
        assert all(0.0 <= v <= 1.0 for v in curve["prob_pred"] + curve["prob_true"])
    # Loose quality sanity only: at 6 races win Brier is too noisy to hold
    # the random-guess 0.0475 baseline (the synthetic ground-truth accuracy
    # gate lives in tests/test_data.py at full-season scale); both sides
    # must land inside the reference CLI's "good" band (backtest.py:40-50).
    assert our_result["win_brier"] < 0.15
    assert ref_result["win_brier"] < 0.15
