"""Data layer: session loading (FastF1 when available), real offline/cached
operation, synthetic data generation, and Elo rating persistence.

The reference README promises offline cache modes (`--offline`,
`--build-cache`, a 3-level Elo cache priority) that its code never implements
(SURVEY.md preamble); here they are implemented for real. Everything in this
package is off the hot path — pandas/numpy are fine; outputs headed for the
engine are converted to dense jnp tensors at the predictor boundary.
"""

from monte_carlo_gp.data.loader import F1DataLoader  # noqa: F401
from monte_carlo_gp.data.synthetic import SyntheticBackend  # noqa: F401
