"""XLA lap-scan engine: sims_per_block sweep at the headline shape.

The block size bounds the per-block working set (`ops/engine.py
DEFAULT_BLOCK`); the optimum depends on the carried bytes per sim and the
memory hierarchy, so it must be re-swept after any carry or layout change.
Not measured on the H100.

Usage (on a GPU): python benchmarks/xla_block_sweep.py [impl]
where impl is an optional bit-source (`threefry2x32` default, `rbg` for the
XLA RngBitGenerator path — ops/rng.engine_key).
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

from benchmarks.common import require_gpu, stage_on_device, standard_params

N_SIMS = 1_048_576
LAPS = 57
BLOCKS = (32_768, 65_536, 131_072, 262_144)


def main() -> None:
    import jax

    from monte_carlo_gp.ops.engine import run_monte_carlo

    impl = sys.argv[1] if len(sys.argv) > 1 else None
    if impl:
        print(f"rng impl: {impl}", file=sys.stderr, flush=True)
    params = standard_params()
    key = jax.random.PRNGKey(42)
    require_gpu()
    params, keys = stage_on_device(params, key, n_keys=3)

    for block in BLOCKS:

        def run(k):
            return run_monte_carlo(
                params, k, N_SIMS, LAPS, sims_per_block=block, rng_impl=impl
            )

        t0 = time.perf_counter()
        run(keys[0]).block_until_ready()  # compile
        print(f"block {block}: cold {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
        times = []
        for k in keys:
            t0 = time.perf_counter()
            run(k).block_until_ready()
            times.append(time.perf_counter() - t0)
        print(
            f"block {block}: best {min(times):.3f}s -> "
            f"{N_SIMS / min(times) / 1e6:.3f}M sims/s",
            flush=True,
        )


if __name__ == "__main__":
    main()
