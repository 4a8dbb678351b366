"""Gradient-boosted qualifying model — the design doc's "Approach C".

The reference's design doc sketches a LightGBM quali regressor trained with
TimeSeriesSplit cross-validation (/root/reference/plan.md:1176-1213) and
lists "LightGBM, scikit-learn" as the intended stack (plan.md:2308), but the
shipped reference implements neither. LightGBM is not available in this
environment; scikit-learn's ``HistGradientBoostingRegressor`` is the same
model family (histogram-binned GBDT with leaf-wise growth, native NaN
handling) and is what this module uses — the sketch's
``num_leaves=31 / learning_rate=0.05 / early stopping`` hyperparameters map
directly.

Training data is built from the same Q-lap archive the Bayesian model uses
(models/bayesian.py), by ONE chronological pass: each (event, driver) row's
features are running aggregates over strictly-earlier events only, so the
frame is leakage-free by construction — row k's features cannot change when
later events are appended (pinned by tests/test_ml.py). The response is the
driver's best-lap percentage gap to the event pole, matching the Bayesian
model's response so the two families are comparable on the same scale.

This is deliberately host-side CPU code (pandas/numpy/sklearn): like the
HMC fit, GBDT training is latency-bound tree construction with no matrix
work — the accelerator stays reserved for the Monte Carlo engine. Prediction
converts the point regression into grid-position distributions by Monte
Carlo ranking under the model's out-of-fold residual noise, giving the same
``dict[str, list[float]]`` contract as the Elo and Bayesian quali paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pandas as pd

from monte_carlo_gp.models.quali_common import (
    rank_draws_to_probs,
    valid_q_rows,
)
from monte_carlo_gp.utils.logging import log_event

FORM_WINDOW = 5  # rolling form over the driver's last 5 events

FEATURES = [
    "last_gap",  # previous event's gap
    "form_gap",  # mean gap over the last FORM_WINDOW events
    "career_gap",  # running mean over all prior events
    "team_gap",  # running mean of the driver's team (teammates pooled)
    "teammate_delta",  # career_gap - team_gap (negative = faster than car)
    "circuit_gap",  # running mean at this circuit
    "n_events",  # prior-event count (experience)
]


@dataclasses.dataclass(frozen=True)
class QualiTrainingData:
    """Chronological training rows: X[i]'s aggregates see only events < i's."""

    X: pd.DataFrame  # (N, len(FEATURES)), NaN where no history exists
    y: np.ndarray  # (N,) float32 gap-to-pole percent at the row's event
    meta: pd.DataFrame  # (N,) Driver / Team / season / circuit per row
    # End-of-pass aggregate state (after folding the WHOLE archive) — exactly
    # what prediction-time features need, so predict reuses it instead of
    # re-folding the archive (O(n_races^2) host work across a walk-forward).
    agg: dict = dataclasses.field(default_factory=dict, repr=False)


def _event_best_gaps(laps: pd.DataFrame, session_type: str | None = "Q"):
    """Per (event, driver): best lap's percentage gap to the event pole,
    in the archive's chronological event order. Yields
    (season, circuit, {driver: (gap, team)}) tuples."""
    rows = valid_q_rows(laps, session_type)
    if "season" not in rows.columns:
        rows = rows.assign(season=0)

    events = []
    # groupby(sort=False) preserves the archive's chronological first-
    # appearance order (loader emits past events in order, seasons ascending).
    for (season, circuit), ev in rows.groupby(["season", "circuit"], sort=False):
        best = ev.groupby("Driver", sort=False).agg(
            lap=("LapTime", "min"), Team=("Team", "last")
        )
        pole = float(best["lap"].min())
        gaps = {
            d: (float((r.lap - pole) / pole * 100.0), r.Team)
            for d, r in best.iterrows()
        }
        events.append((season, circuit, gaps))
    return events


def build_training_frame(
    laps: pd.DataFrame, session_type: str | None = "Q"
) -> QualiTrainingData:
    """One chronological pass over the archive → leakage-free rows.

    Running aggregates (driver form/career, team pool, driver-at-circuit)
    are READ to form event e's feature rows and only then UPDATED with
    event e's outcomes, so appending later events can never change earlier
    rows. First appearances get NaN features — HistGradientBoostingRegressor
    consumes NaN natively (the LightGBM-parity behavior the sketch relies
    on), so rookies need no imputation."""
    events = _event_best_gaps(laps, session_type)

    hist: dict[str, list[float]] = {}  # driver -> prior gaps (chronological)
    team_sum: dict[str, float] = {}
    team_n: dict[str, int] = {}
    circ_sum: dict[tuple, float] = {}
    circ_n: dict[tuple, int] = {}

    feats, targets, meta = [], [], []
    last_team: dict[str, str] = {}
    for season, circuit, gaps in events:
        # READ phase: features from strictly-earlier events.
        for d, (gap, team) in gaps.items():
            h = hist.get(d, [])
            career = float(np.mean(h)) if h else np.nan
            tg = team_sum[team] / team_n[team] if team_n.get(team) else np.nan
            ck = (d, circuit)
            feats.append(
                {
                    "last_gap": h[-1] if h else np.nan,
                    "form_gap": float(np.mean(h[-FORM_WINDOW:])) if h else np.nan,
                    "career_gap": career,
                    "team_gap": tg,
                    "teammate_delta": career - tg
                    if h and team_n.get(team)
                    else np.nan,
                    "circuit_gap": circ_sum[ck] / circ_n[ck]
                    if circ_n.get(ck)
                    else np.nan,
                    "n_events": float(len(h)),
                }
            )
            targets.append(gap)
            meta.append(
                {"Driver": d, "Team": team, "season": season, "circuit": circuit}
            )
        # UPDATE phase: fold event e into the aggregates.
        for d, (gap, team) in gaps.items():
            hist.setdefault(d, []).append(gap)
            team_sum[team] = team_sum.get(team, 0.0) + gap
            team_n[team] = team_n.get(team, 0) + 1
            ck = (d, circuit)
            circ_sum[ck] = circ_sum.get(ck, 0.0) + gap
            circ_n[ck] = circ_n.get(ck, 0) + 1
            last_team[d] = team

    return QualiTrainingData(
        X=pd.DataFrame(feats, columns=FEATURES),
        y=np.asarray(targets, np.float32),
        meta=pd.DataFrame(meta),
        agg={
            "hist": hist,
            "team_sum": team_sum,
            "team_n": team_n,
            "circ_sum": circ_sum,
            "circ_n": circ_n,
            "last_team": last_team,
        },
    )


def _current_features(
    laps: pd.DataFrame,
    drivers: list[str],
    driver_teams: dict[str, str | None],
    circuit: str,
    session_type: str | None = "Q",
    agg: dict | None = None,
) -> pd.DataFrame:
    """As-of-now feature rows for a weekend field: the same aggregates the
    training pass maintains, folded over the ENTIRE archive (prediction time
    is after every archived event). Unknown drivers/teams yield NaN rows —
    the model's native missing-data path.

    `agg` short-circuits the fold with `build_training_frame`'s end-of-pass
    state (QualiTrainingData.agg) — the training pass already folded the
    whole archive, so prediction need not pay a second full pandas pass
    per walk-forward race."""
    if agg is None:
        agg = build_training_frame(laps, session_type).agg
    hist: dict[str, list[float]] = agg["hist"]
    team_sum: dict[str, float] = agg["team_sum"]
    team_n: dict[str, int] = agg["team_n"]
    circ_sum: dict[tuple, float] = agg["circ_sum"]
    circ_n: dict[tuple, int] = agg["circ_n"]
    last_team: dict[str, str] = agg["last_team"]

    rows = []
    for d in drivers:
        h = hist.get(d, [])
        career = float(np.mean(h)) if h else np.nan
        team = driver_teams.get(d) or last_team.get(d)
        tg = (
            team_sum[team] / team_n[team]
            if team is not None and team_n.get(team)
            else np.nan
        )
        ck = (d, circuit)
        rows.append(
            {
                "last_gap": h[-1] if h else np.nan,
                "form_gap": float(np.mean(h[-FORM_WINDOW:])) if h else np.nan,
                "career_gap": career,
                "team_gap": tg,
                "teammate_delta": career - tg
                if h and team is not None and team_n.get(team)
                else np.nan,
                "circuit_gap": circ_sum[ck] / circ_n[ck]
                if circ_n.get(ck)
                else np.nan,
                "n_events": float(len(h)),
            }
        )
    return pd.DataFrame(rows, columns=FEATURES, index=drivers)


class GBMQualiModel:
    """TimeSeriesSplit-ensembled gradient boosting over the quali archive.

    Mirrors the sketch's training loop (plan.md:1183-1211): 5 expanding-
    window folds, one model per fold with early stopping, the ensemble kept
    (prediction averages the folds). Hyperparameters map num_leaves→
    max_leaf_nodes, learning_rate, 1000 rounds, early stopping — sklearn's
    HGBR early-stops on an internal validation fraction of the fold's train
    split rather than the sketch's explicit val set (the fold val set is
    held out purely for the residual estimate, which is what prediction
    noise needs to be honest about).

    Fit caching matches BayesianQualiModel: keyed on the archive frame's
    unforgeable loader token, so walk-forward backtests refit per race
    (leakage-safe) while repeated weekend predictions reuse the ensemble.
    """

    def __init__(
        self,
        n_splits: int = 5,
        max_iter: int = 1000,
        learning_rate: float = 0.05,
        max_leaf_nodes: int = 31,
        n_grid_draws: int = 2000,
        seed: int = 42,
    ):
        self.n_splits = n_splits
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.max_leaf_nodes = max_leaf_nodes
        self.n_grid_draws = n_grid_draws
        self.seed = seed
        self._models: list | None = None
        self._agg: dict | None = None
        self._resid_sigma: float | None = None
        self._token: object | None = None

    def fit(self, laps: pd.DataFrame) -> "GBMQualiModel":
        from sklearn.ensemble import HistGradientBoostingRegressor
        from sklearn.model_selection import TimeSeriesSplit

        data = build_training_frame(laps)
        n = len(data.y)
        n_splits = min(self.n_splits, max(2, n // 20)) if n >= 40 else 2
        if n < 2 * (n_splits + 1):
            raise ValueError(
                f"not enough training rows for TimeSeriesSplit "
                f"(need >= {2 * (n_splits + 1)}, archive has {n})"
            )
        tscv = TimeSeriesSplit(n_splits=n_splits)
        models, residuals = [], []
        for train_idx, val_idx in tscv.split(data.X):
            Xt = data.X.iloc[train_idx]
            # Early expanding-window folds can have columns with NO observed
            # values yet (e.g. circuit_gap before any circuit repeats);
            # HGBR tolerates NaNs but its binner rejects an all-NaN column —
            # fit each fold on the columns it has actually seen.
            cols = [c for c in Xt.columns if Xt[c].notna().any()]
            m = HistGradientBoostingRegressor(
                loss="squared_error",
                learning_rate=self.learning_rate,
                max_leaf_nodes=self.max_leaf_nodes,
                max_iter=self.max_iter,
                # sklearn's default (20) forbids ANY split on the small
                # expanding-window early folds (a split needs 2 leaves ≥
                # min_samples_leaf) — scale it down with the fold, keep the
                # default once folds are big enough for it to matter.
                min_samples_leaf=int(max(2, min(20, len(train_idx) // 8))),
                early_stopping=True,
                validation_fraction=0.15,
                n_iter_no_change=50,
                random_state=self.seed,
            )
            m.fit(Xt[cols], data.y[train_idx])
            models.append((m, cols))
            residuals.append(
                data.y[val_idx] - m.predict(data.X.iloc[val_idx][cols])
            )
        self._models = models
        self._agg = data.agg
        pooled = np.concatenate(residuals)
        # RMS about ZERO, not np.std: std subtracts the pooled mean, which
        # would hide any systematic prediction bias (early expanding-window
        # folds train on near-featureless rows) and understate the honest
        # prediction-error spread sqrt(var + bias^2).
        self._resid_sigma = float(
            max(np.sqrt(np.mean(np.square(pooled))), 1e-3)
        )
        self._token = laps.attrs.get("_mcgp_loader_token")
        log_event(
            "gbm_quali_fit",
            rows=n,
            folds=len(models),
            resid_sigma=self._resid_sigma,
        )
        return self

    def _ensure_fit(self, laps: pd.DataFrame) -> None:
        from monte_carlo_gp.models.quali_common import needs_refit

        token = laps.attrs.get("_mcgp_loader_token")
        if needs_refit(self._models, token, self._token):
            self.fit(laps)

    def predict_gaps(
        self,
        laps: pd.DataFrame,
        drivers: list[str],
        driver_teams: dict[str, str | None],
        circuit: str,
    ) -> np.ndarray:
        """Fold-ensemble mean predicted gap-to-pole percent per driver."""
        self._ensure_fit(laps)
        # The fit's token cache guarantees self._agg was folded from THIS
        # archive build (a different token refits just above).
        X = _current_features(
            laps, drivers, driver_teams, circuit, agg=self._agg
        )
        preds = np.stack([m.predict(X[cols]) for m, cols in self._models])
        return preds.mean(axis=0)

    def predict(
        self,
        laps: pd.DataFrame,
        drivers: list[str],
        driver_teams: dict[str, str | None],
        circuit: str,
        seed: int = 0,
    ) -> dict[str, list[float]]:
        """Grid-position distributions: Monte Carlo ranking of the point
        predictions under the out-of-fold residual noise — the same
        dict[str, list[float]] contract as the Elo and Bayesian paths."""
        n = len(drivers)
        if n == 0:
            return {}
        mu = self.predict_gaps(laps, drivers, driver_teams, circuit)
        rng = np.random.default_rng(seed)
        draws = mu[None, :] + self._resid_sigma * rng.standard_normal(
            (self.n_grid_draws, n)
        )
        return rank_draws_to_probs(draws, drivers)
