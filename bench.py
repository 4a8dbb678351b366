"""Benchmark: race simulations/second on one GPU at 20 drivers x 57 laps.

Prints ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": "sims/s", "vs_baseline": N,
     "cold_s": N, "n_sims": N, "device": {...}, "gpu": {...}}

The XLA lap-scan engine runs 1,048,576 sims in 65,536-sim blocks.
`cold_s` is the first call (compile + run); `value` is the best of four
warm calls, each timed to `block_until_ready`. `device` is JAX's record
(platform, device_kind, count) and `gpu` the card's name and power limit
from nvidia-smi, so every number carries the hardware it was taken on.

Baseline: the reference (dan-lee-gh/monte-carlo-gp) is a serial
pure-Python engine at order 500 sims/sec on CPU (BASELINE.md "reference
comparison point"). vs_baseline = value/500.

Without a GPU it exits 1 and prints no number: a CPU rate is not a device
metric. Diagnostics go to stderr.
"""

import json
import sys
import time

METRIC = "race_sims_per_sec_per_chip_20drv_57laps"
REFERENCE_SIMS_PER_SEC = 500.0  # serial Python reference, CPU (BASELINE.md)
N_DRIVERS = 20
TOTAL_LAPS = 57
N_SIMS = 1_048_576
WARM_RUNS = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def measure(devices) -> dict:
    """Time the engine on `devices[0]` and return the JSON record."""
    import jax
    import numpy as np

    from benchmarks.common import standard_params
    from monte_carlo_gp.ops.engine import DEFAULT_BLOCK, run_monte_carlo
    from monte_carlo_gp.utils.device import device_record, query_gpus

    _, gpus = query_gpus()
    params = jax.device_put(standard_params(N_DRIVERS))
    key = jax.device_put(jax.random.PRNGKey(42))

    def run(k):
        return run_monte_carlo(
            params, k, N_SIMS, TOTAL_LAPS, sims_per_block=DEFAULT_BLOCK
        ).block_until_ready()

    t0 = time.perf_counter()
    run(key)
    cold_s = time.perf_counter() - t0
    log(f"cold (compile+run): {cold_s:.2f}s")

    times = []
    for i in range(WARM_RUNS):
        k = jax.device_put(jax.random.fold_in(key, i))
        t0 = time.perf_counter()
        probs = run(k)
        times.append(time.perf_counter() - t0)
    log(f"warm runs: {[f'{t:.4f}' for t in times]}")

    if not np.allclose(np.asarray(probs).sum(axis=1), 1.0, atol=1e-5):
        raise RuntimeError("invalid histogram: rows do not sum to 1")

    sims_per_sec = N_SIMS / min(times)
    return {
        "metric": METRIC,
        "value": sims_per_sec,
        "unit": "sims/s",
        "vs_baseline": sims_per_sec / REFERENCE_SIMS_PER_SEC,
        "cold_s": cold_s,
        "n_sims": N_SIMS,
        "device": device_record(devices),
        "gpu": gpus[0],
    }


def main() -> int:
    import jax

    from monte_carlo_gp.utils.device import NoGpuError, require_gpu

    devices = jax.devices()
    try:
        require_gpu(devices)
    except NoGpuError as e:
        log(f"bench.py measures the GPU only: {e}")
        return 1
    print(json.dumps(measure(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
