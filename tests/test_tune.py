"""Parameter-sweep tuning (validate/tune.py): override semantics, grid
expansion, the shared-prep/shared-compile sweep, and its contracts —
default config == backtest_model_batched exactly, identity overrides are
bitwise no-ops, pole_brier is invariant across configs (race-sim scalars
cannot touch the quali model), and the sweep is deterministic."""

import numpy as np
import pytest

from monte_carlo_gp.config import make_sim_params
from monte_carlo_gp.data.synthetic import SyntheticBackend
from monte_carlo_gp.models.predictor import F1Predictor
from monte_carlo_gp.validate.tune import (
    apply_overrides,
    expand_grid,
    sweep_backtest,
)


def _params(d=4):
    gp = np.full((d, d), 1.0 / d, np.float32)
    return make_sim_params(
        grid_probs=gp,
        base_pace=np.full(d, 90.0),
        tire_deg=np.full(d, 0.05),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.001),
        team_dnf_rate=np.full(d, 0.002),
    )


def _factory(tmp_path, n_events=3):
    def make():
        return F1Predictor(
            cache_dir=tmp_path,
            backend=SyntheticBackend(seed=5, n_events=n_events),
        )

    return make


# -- unit: apply_overrides / expand_grid -------------------------------------


def test_apply_overrides_scalar_and_scale():
    p = _params()
    q = apply_overrides(p, {"sc_prob": 0.02, "variance_scale": 1.5})
    assert float(q.sc_prob) == np.float32(0.02)
    assert np.allclose(np.asarray(q.variance), 0.15 * 1.5)
    # untouched leaves are the same objects (no copy, same compiled program)
    assert q.base_pace is p.base_pace
    assert q.grid_probs is p.grid_probs


def test_apply_overrides_identity_is_noop():
    p = _params()
    assert apply_overrides(p, {}) is p
    assert apply_overrides(p, {"variance_scale": 1.0}) is p


def test_apply_overrides_unknown_key_raises():
    with pytest.raises(ValueError, match="unknown sweep key"):
        apply_overrides(_params(), {"warp_drive": 2.0})


def test_expand_grid_product_and_validation():
    g = expand_grid({"sc_prob": [0.01, 0.02], "variance_scale": [1.0, 1.5]})
    assert len(g) == 4
    assert g[0] == {"sc_prob": 0.01, "variance_scale": 1.0}
    assert g[-1] == {"sc_prob": 0.02, "variance_scale": 1.5}
    with pytest.raises(ValueError, match="unknown sweep key"):
        expand_grid({"nope": [1.0]})


def test_sweep_rejects_empty_grid_and_bad_metric(tmp_path):
    with pytest.raises(ValueError, match="no configurations"):
        sweep_backtest(_factory(tmp_path), [2024], {"sc_prob": []})
    with pytest.raises(ValueError, match="unknown metric"):
        sweep_backtest(
            _factory(tmp_path), [2024], {"sc_prob": [0.01]}, metric="vibes"
        )
    # pole_brier is config-invariant (race-sim scalars cannot reach the
    # quali model), so ranking by it would silently return grid order.
    with pytest.raises(ValueError, match="pole_brier cannot rank"):
        sweep_backtest(
            _factory(tmp_path), [2024], {"sc_prob": [0.01]},
            metric="pole_brier",
        )


# -- the sweep itself ---------------------------------------------------------


@pytest.fixture(scope="module")
def sweep_out(tmp_path_factory):
    """One shared sweep run (2x2 grid + default) on the synthetic world."""
    tmp = tmp_path_factory.mktemp("tune")
    return sweep_backtest(
        _factory(tmp),
        [2024],
        {"sc_prob": [0.01, 0.05], "variance_scale": [1.0, 8.0]},
        seed=3,
        n_simulations=512,
        engine="xla",
        verbose=False,
    )


@pytest.mark.slow
def test_sweep_shape_and_ranking(sweep_out):
    out = sweep_out
    assert out["n_configs"] == 4 and len(out["results"]) == 4
    assert out["best"] is out["results"][0]
    # sorted ascending by win_brier (lower = better)
    briers = [r["win_brier"] for r in out["results"]]
    assert briers == sorted(briers)
    for rec in out["results"]:
        assert rec["n_races"] == 3
        assert 0.0 <= rec["win_brier"] <= 2.0
        assert set(rec["overrides"]) == {"sc_prob", "variance_scale"}


@pytest.mark.slow
def test_sweep_pole_brier_invariant_across_configs(sweep_out):
    """Race-sim scalars cannot reach the quali model: pole_brier must be
    bit-identical for every config (a built-in sweep self-check)."""
    poles = {r["pole_brier"] for r in sweep_out["results"]}
    poles.add(sweep_out["default"]["pole_brier"])
    assert len(poles) == 1


@pytest.mark.slow
def test_sweep_default_matches_batched_backtest(tmp_path, sweep_out):
    """The un-overridden config IS backtest_model_batched: same prep, same
    fold_in key chain, same engine -> exactly equal metrics."""
    from monte_carlo_gp.validate.backtest import backtest_model_batched

    bat = backtest_model_batched(
        _factory(tmp_path), [2024], seed=3, n_simulations=512,
        engine="xla", verbose=False,
    )
    d = sweep_out["default"]
    assert d["n_races"] == bat["n_races"]
    assert d["pole_brier"] == bat["pole_brier"]
    assert d["win_brier"] == bat["win_brier"]
    assert d["podium_accuracy"] == bat["podium_accuracy"]


@pytest.mark.slow
def test_sweep_identity_config_equals_default(sweep_out):
    """sc_prob=0.01 (the default value) + variance_scale=1.0 (skipped) is a
    bitwise identity override -> identical metrics to the default record
    (common random numbers make this exact, not statistical)."""
    identity = next(
        r for r in sweep_out["results"]
        if r["overrides"] == {"sc_prob": 0.01, "variance_scale": 1.0}
    )
    d = sweep_out["default"]
    assert identity["win_brier"] == d["win_brier"]
    assert identity["podium_accuracy"] == d["podium_accuracy"]


@pytest.mark.slow
def test_sweep_overrides_change_outcomes(sweep_out):
    """An 8x variance scale must actually move the race outcome metric
    (if it didn't, the override never reached the device)."""
    d = sweep_out["default"]
    scaled = next(
        r for r in sweep_out["results"]
        if r["overrides"] == {"sc_prob": 0.01, "variance_scale": 8.0}
    )
    assert scaled["win_brier"] != d["win_brier"]


@pytest.mark.slow
def test_sweep_deterministic(tmp_path):
    kwargs = dict(
        seed=7, n_simulations=256, engine="xla", verbose=False,
        include_default=False,
    )
    grid = {"drs_delta": [0.1, 0.5]}
    a = sweep_backtest(_factory(tmp_path, 2), [2024], grid, **kwargs)
    b = sweep_backtest(_factory(tmp_path, 2), [2024], grid, **kwargs)
    assert a["results"] == b["results"]
