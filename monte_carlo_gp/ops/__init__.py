"""Device compute: ranking, grid sampling, the lap engine and the
Monte Carlo driver. Everything here is pure, jittable, and batched over a
leading simulation axis."""

from monte_carlo_gp.ops.engine import run_monte_carlo, simulate_races  # noqa: F401
from monte_carlo_gp.ops.grid_sampling import sample_grid  # noqa: F401
from monte_carlo_gp.ops.ranking import (  # noqa: F401
    gather_at_rank,
    rank_by,
    scatter_by_rank,
)
