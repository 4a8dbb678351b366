"""Elo system: exact agreement with the sequential oracle (same math, so
equality is to float tolerance, not statistical)."""

import numpy as np

from monte_carlo_gp.models.elo import F1EloSystem, recency_k

from oracle.reference_elo import OracleElo


def _random_history(seed=0, n_events=30, n_drivers=12):
    rng = np.random.default_rng(seed)
    names = [f"D{i:02d}" for i in range(n_drivers)]
    events = []
    for e in range(n_events):
        k = rng.integers(4, n_drivers + 1)
        drivers = rng.choice(names, size=k, replace=False)
        if e % 2 == 0:  # quali: lap times
            vals = 88.0 + rng.random(k) * 3.0
            events.append(("quali", list(zip(drivers.tolist(), vals.tolist()))))
        else:  # race: positions
            pos = rng.permutation(k) + 1
            events.append(("race", list(zip(drivers.tolist(), pos.tolist()))))
    return events


def test_matches_oracle_on_random_history():
    events = _random_history()
    oracle = OracleElo()
    system = F1EloSystem()
    for i, (kind, results) in enumerate(events):
        # vary K like the predictor does
        oracle.set_recency_weight(i % 3, race_index=i, total_races=len(events))
        system.set_recency_weight(i % 3, race_index=i, total_races=len(events))
        if kind == "quali":
            oracle.update_quali(results)
            system.update_quali_ratings(results)
        else:
            oracle.update_race(results)
            system.update_race_ratings(results)
    for name in oracle.ratings:
        assert abs(system.get_rating(name, "quali") - oracle.ratings[name]["quali"]) < 2e-2
        assert abs(system.get_rating(name, "race") - oracle.ratings[name]["race"]) < 2e-2


def test_tie_handling():
    system = F1EloSystem()
    oracle = OracleElo()
    results = [("A", 90.0), ("B", 90.0), ("C", 91.0)]
    system.update_quali_ratings(results)
    oracle.update_quali(results)
    for d in "ABC":
        assert abs(system.get_rating(d) - oracle.ratings[d]["quali"]) < 1e-3
    # A and B tied -> identical ratings
    assert abs(system.get_rating("A") - system.get_rating("B")) < 1e-4


def test_single_driver_event_is_noop():
    system = F1EloSystem()
    system.update_quali_ratings([("A", 90.0)])
    assert system.get_rating("A") == 1500.0


def test_unknown_driver_default():
    system = F1EloSystem()
    assert system.get_rating("ZZZ") == 1500.0
    assert system.get_rating("ZZZ", "race") == 1500.0


def test_ordered_list_form_equals_position_pairs():
    """The corrected backtest path: an ordered abbreviation list is
    equivalent to explicit (driver, position) pairs."""
    a, b = F1EloSystem(), F1EloSystem()
    a.update_race_ratings(["X", "Y", "Z"])
    b.update_race_ratings([("X", 1), ("Y", 2), ("Z", 3)])
    for d in "XYZ":
        assert abs(a.get_rating(d, "race") - b.get_rating(d, "race")) < 1e-4


def test_softmax_probs_match_oracle():
    system = F1EloSystem()
    oracle = OracleElo()
    results = [("A", 1), ("B", 2), ("C", 3), ("D", 4)]
    system.update_quali_ratings([(d, float(v)) for d, v in results])
    oracle.update_quali([(d, float(v)) for d, v in results])
    p_sys = system.predict_quali_probs(["A", "B", "C", "D", "E"])
    p_or = oracle.predict_quali_probs(["A", "B", "C", "D", "E"])
    assert abs(sum(p_sys.values()) - 1.0) < 1e-5
    for d in p_or:
        assert abs(p_sys[d] - p_or[d]) < 1e-4
    assert p_sys["A"] > p_sys["B"] > p_sys["C"] > p_sys["D"]


def test_recency_k_schedule():
    assert recency_k(32, 0, 0, 24) == 32 * 0.75
    assert recency_k(32, 0, 23, 24) == 32 * 1.5
    assert recency_k(32, 1) == 32.0
    assert recency_k(32, 2) == 32 * 0.7
    assert recency_k(32, 3) == 32 * 0.5
    assert recency_k(32, 10) == 32 * 0.5


def test_state_dict_roundtrip():
    system = F1EloSystem()
    system.update_race_ratings([("A", 1), ("B", 2)])
    state = system.state_dict()
    restored = F1EloSystem.from_state_dict(state)
    assert restored.get_rating("A", "race") == system.get_rating("A", "race")
    assert restored.names == system.names


def test_flush_without_cpu_backend(monkeypatch):
    """A process limited to the GPU (JAX_PLATFORMS=cuda) has no 'cpu'
    backend, so the flush's CPU pin (`jax.local_devices(backend="cpu")`)
    raises RuntimeError there. flush must fall back to the default device
    instead of crashing the prediction CLI."""
    import jax

    def no_cpu_backend(*args, **kwargs):
        raise RuntimeError("Unknown backend cpu. Available backends are ['cuda']")

    monkeypatch.setattr(jax, "local_devices", no_cpu_backend)
    system = F1EloSystem()
    system.update_race_ratings([("A", 1), ("B", 2)])
    system.flush()
    assert system.get_rating("A", "race") > system.get_rating("B", "race")


def test_interleaved_flushes_match_single_flush():
    """Batched scan flushes must commute with query points: flushing after
    every event equals flushing once at the end, including when new drivers
    appear mid-history."""
    events = _random_history(seed=3, n_events=12, n_drivers=8)
    eager, lazy = F1EloSystem(), F1EloSystem()
    for kind, results in events:
        for s in (eager, lazy):
            (s.update_quali_ratings if kind == "quali" else s.update_race_ratings)(results)
        eager.flush()
        # mid-history: intern a brand-new driver only into `eager`'s table
    eager.update_race_ratings([("NEW", 1), ("D00", 2)])
    lazy.update_race_ratings([("NEW", 1), ("D00", 2)])
    for name in eager.names:
        assert abs(eager.get_rating(name, "quali") - lazy.get_rating(name, "quali")) < 1e-3
        assert abs(eager.get_rating(name, "race") - lazy.get_rating(name, "race")) < 1e-3
