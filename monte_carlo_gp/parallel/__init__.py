"""Multi-device scale-out: device meshes and sharded Monte Carlo batches.

The reference has no parallelism of any kind (SURVEY.md §2 parallelism
inventory); this package is where the rebuild scales: simulations shard
over a 'sims' mesh axis, whole seasons of races over a 'race' axis, with the
only cross-device traffic being the final finish-histogram reductions
(psum-sized: D x D int32 per race) inserted automatically by GSPMD.
"""

from monte_carlo_gp.parallel.mesh import make_mesh, sharded_monte_carlo  # noqa: F401
from monte_carlo_gp.parallel.sharded import simulate_season_sharded, stack_params  # noqa: F401
