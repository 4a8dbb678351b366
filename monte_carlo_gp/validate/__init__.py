"""Validation: Brier/podium/calibration metrics, the season backtest, and
the event-model parameter sweep (`validate.tune`)."""

from monte_carlo_gp.validate.backtest import backtest_model, get_actual_results, get_races  # noqa: F401
from monte_carlo_gp.validate.tune import sweep_backtest  # noqa: F401
from monte_carlo_gp.validate.metrics import (  # noqa: F401
    brier_score,
    calibration_analysis,
    podium_accuracy,
)
