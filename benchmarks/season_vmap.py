"""Season multi-race path vs the flat single-race engine (same total sims).

parallel/sharded.py runs a season's races as a `lax.map` of flat
single-race programs inside one compile, because vmapping the race axis
makes XLA lay out the batched (R, S, D[, D]) intermediates far worse than
the flat engine's. This harness times the season path against the flat
engine at the same total sims and the same masked lap bucket; the ratio
should stay near 1. Not measured on the H100.

Usage (on a GPU): python benchmarks/season_vmap.py [impl]   # threefry2x32 | rbg
Timings follow benchmarks/README.md: device-staged inputs, every timed call
ends in `block_until_ready`, best-of-N warm.
"""

import os
import sys
import time
from pathlib import Path

# MCGP_RNG_IMPL is read at call time (ops/rng.default_impl), but set it
# before any imports anyway so the harness can't drift if that changes.
IMPL = sys.argv[1] if len(sys.argv) > 1 else None
if IMPL:
    os.environ["MCGP_RNG_IMPL"] = IMPL

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

from benchmarks.common import require_gpu, standard_params  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from monte_carlo_gp.ops.engine import run_monte_carlo  # noqa: E402
from monte_carlo_gp.parallel.sharded import (  # noqa: E402
    stack_params,
    _season_probs,
)
from monte_carlo_gp.parallel.mesh import make_mesh  # noqa: E402

R = int(os.environ.get("SV_R", 20))           # races
S = int(os.environ.get("SV_S", 10_240))       # sims/race -> R*S = 204,800
LAPS = int(os.environ.get("SV_LAPS", 78))     # max-lap bucket (masked to 57)
D = 20
REPS = 3


def main():
    require_gpu()
    params = standard_params(D)
    key = jax.random.PRNGKey(0)
    params = jax.device_put(params)
    key = jax.device_put(key)

    # --- flat engine at the same total sims and the same masked bucket ----
    race_laps = jax.device_put(jnp.int32(57))
    flat = run_monte_carlo(params, key, R * S, LAPS, race_laps=race_laps)
    flat.block_until_ready()  # compile + warm
    t_flat = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        run_monte_carlo(
            params, key, R * S, LAPS, race_laps=race_laps
        ).block_until_ready()
        t_flat.append(time.perf_counter() - t0)
    flat_s = min(t_flat)

    # --- multi-race season path (single device mesh: isolates layout cost)
    params_list = [params] * R
    laps_list = [57] * R
    mesh = make_mesh({"race": 1, "sims": 1})
    stacked, _ = stack_params(params_list)
    stacked = jax.device_put(stacked)
    laps_arr = jax.device_put(jnp.full((R,), 57, jnp.int32))
    keys = jax.vmap(lambda r: jax.random.fold_in(key, r))(jnp.arange(R))
    keys = jax.device_put(keys)

    def season():
        with jax.set_mesh(mesh):
            return _season_probs(
                stacked, laps_arr, keys, S, LAPS, mesh, "race", "sims"
            ).block_until_ready()

    season()  # compile + warm
    t_vmap = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        season()
        t_vmap.append(time.perf_counter() - t0)
    vmap_s = min(t_vmap)

    total = R * S
    print(
        f"impl={IMPL or 'default'} flat: {flat_s:.3f}s ({total/flat_s/1e6:.3f}M sims/s)  "
        f"season: {vmap_s:.3f}s ({total/vmap_s/1e6:.3f}M sims/s)  "
        f"penalty: {vmap_s/flat_s:.2f}x"
    )


if __name__ == "__main__":
    main()
