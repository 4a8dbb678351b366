"""Serving-path latency: warm PredictionService.predict() on one GPU.

Measures what a production client sees from the resident server once plans
and compiles are warm: request -> validated -> cached WeekendPlan ->
simulate_plan (device) -> assemble_result (host). The HTTP layer is
covered by tests/test_serve.py.

    python benchmarks/serve_latency.py [n_sims] [n_requests]

Reports per-request wall-clock p50/p95/min plus the device-only simulate
time for the same shape, so the host/assembly overhead is visible
separately. Not measured on the H100.
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

N_SIMS = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
N_REQ = int(sys.argv[2]) if len(sys.argv) > 2 else 20


def main():
    from monte_carlo_gp.data.synthetic import SyntheticBackend
    from monte_carlo_gp.models.predictor import F1Predictor
    from monte_carlo_gp.serve import PredictionService

    from benchmarks.common import require_gpu

    require_gpu()
    predictor = F1Predictor(
        cache_dir="./cache", backend=SyntheticBackend(seed=5, n_events=3),
        engine="auto",
    )
    service = PredictionService(predictor, default_simulations=N_SIMS)

    t_warm = service.warmup(2024, "Bahrain")
    print(f"warmup (prepare + compile): {t_warm:.1f}s", file=sys.stderr)

    lat = []
    for i in range(N_REQ):
        t0 = time.perf_counter()
        status, payload = service.predict(
            {"season": 2024, "race": "Bahrain", "seed": i}
        )
        lat.append(time.perf_counter() - t0)
        assert status == 200, payload
    lat = np.array(lat)

    # Device-only simulate for the same shape (same plan; simulate_plan
    # returns a host array, so each call ends when the device is done).
    plan = service.plan_for(2024, "Bahrain", "fp2")
    dev = []
    for i in range(4):
        t0 = time.perf_counter()
        service.predictor.simulate_plan(plan, N_SIMS, seed=100 + i)
        dev.append(time.perf_counter() - t0)

    print(
        f"requests={N_REQ} n_sims={N_SIMS}: "
        f"p50 {np.percentile(lat, 50) * 1e3:.1f} ms, "
        f"p95 {np.percentile(lat, 95) * 1e3:.1f} ms, "
        f"min {lat.min() * 1e3:.1f} ms | "
        f"simulate-only best {min(dev) * 1e3:.1f} ms"
    )


if __name__ == "__main__":
    main()
