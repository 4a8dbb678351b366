"""Model layer: Elo ratings, feature engineering, and the weekend predictor."""

from monte_carlo_gp.models.bayesian import (  # noqa: F401
    BayesianQualiModel,
    build_quali_design,
    quali_position_probs,
    sample_posterior,
    split_rhat,
)
from monte_carlo_gp.models.elo import EloParams, F1EloSystem  # noqa: F401
from monte_carlo_gp.models.ml import (  # noqa: F401
    GBMQualiModel,
    build_training_frame,
)
from monte_carlo_gp.models.safety import (  # noqa: F401
    InsufficientDataError,
    PredictionError,
    generate_fallback_predictions,
    safe_predict,
)
