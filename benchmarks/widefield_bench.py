"""Wide-field bench: XLA engine sims/s across driver counts.

Measures the engine at D in {20, 40, 80} — 262k sims x 57 laps, best-of-3
warm, device-staged inputs. The rank passes are O(D^2) per lap, so the rate
falls faster than 1/D. Not measured on the H100.

Usage (on a GPU):
    python benchmarks/widefield_bench.py            # D=20/40/80
    python benchmarks/widefield_bench.py 40 80      # chosen field sizes
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

from benchmarks.common import require_gpu, stage_on_device, standard_params

N_SIMS = 262_144
LAPS = 57


def main() -> None:
    import jax

    from monte_carlo_gp.ops.engine import DEFAULT_BLOCK, run_monte_carlo

    fields = [int(a) for a in sys.argv[1:]] or [20, 40, 80]
    require_gpu()

    def run(params, k):
        return run_monte_carlo(
            params, k, N_SIMS, LAPS, sims_per_block=min(DEFAULT_BLOCK, N_SIMS)
        )

    for d in fields:
        params, keys = stage_on_device(
            standard_params(d), jax.random.PRNGKey(42), n_keys=3
        )
        t0 = time.perf_counter()
        probs = run(params, keys[0]).block_until_ready()
        cold = time.perf_counter() - t0
        assert abs(float(probs.sum()) - d) < 1e-2, float(probs.sum())
        times = []
        for k in keys:
            t0 = time.perf_counter()
            run(params, k).block_until_ready()
            times.append(time.perf_counter() - t0)
        best = min(times)
        print(
            f"xla D={d}: cold {cold:.1f}s best {best:.3f}s "
            f"-> {N_SIMS/best/1e6:.3f}M sims/s",
            flush=True,
        )


if __name__ == "__main__":
    main()
