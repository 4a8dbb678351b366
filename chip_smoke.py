"""Smoke test of the simulator's main path on NVIDIA GPUs.

    python chip_smoke.py          # one GPU: phases 0-5 below
    python chip_smoke.py --four   # four GPUs: the multi-device comparisons only

One process drives the card(s); nothing else opens them while it runs.
Every phase either passes or raises, and an uncaught error exits non-zero
before the final line is printed. Phases on one GPU:

  0. the `gpu`-marked tests, in a child pytest that exits before this
     process first touches JAX;
  1. the device: JAX's platform must be "gpu"; prints device_kind, the
     device count, nvidia-smi's name and power limit, the jax/jaxlib
     versions and whether pandas and pyarrow import;
  2. the engine at full width: 1,048,576 sims x 20 drivers of a 57-lap
     race in the 64-lap compile bucket, in 65,536-sim blocks (the call
     `F1Predictor.simulate_plan` makes for Bahrain) — compile and warm
     seconds, `memory_analysis`, row/column sums, determinism, and
     bucket-exactness against the plain 57-lap scan;
  3. the engine against the native C++ oracle of the reference semantics
     (native/oracle.cpp) at D = 20, 40, 80;
  4. the batched season program of `backtest.py --batched` over every
     calendar circuit's lap count at 10,000 sims per race;
  5. served predictions: a `PredictionService` over the synthetic world
     answers a plain request, its repeat and a grid-penalty request.

Precision: the engine computes no dot products (ranking is relational
selects, ops/ranking.py), so TF32 cannot enter. XLA:GPU's log/exp/erf_inv
differ from XLA:CPU's and the oracle's libm in the last bits, so every
comparison between the card and the CPU or the oracle is statistical —
per-driver total variation under the bounds of tests/test_engine_stats.py
— and every comparison on the card alone is bitwise.

The last line of stdout is the JSON record
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

N_DRIVERS = 20
RACE_LAPS = 57  # Bahrain
BUCKET_LAPS = 64  # models/predictor._lap_bucket(57)
FULL_SIMS = 1_048_576
BLOCK = 65_536

# (drivers, native-oracle sims, per-driver TV bound): the sizes and bounds of
# tests/test_engine_stats.py's native-oracle anchors.
ORACLE_CASES = ((20, 400_000, 0.012), (40, 200_000, 0.025), (80, 100_000, 0.04))
ORACLE_LAPS = 30
ORACLE_CHUNKS = 8  # independent oracle seeds run on host threads in parallel
# The engine side: ORACLE_ENGINE_CALLS independently keyed calls of
# ORACLE_ENGINE_CALL_SIMS sims each. One call has the shape of the gpu-marked
# D=80 anchor test (16,384 sims x 30 laps), so at D=80 the persistent
# compilation cache serves the program phase 0 compiled (the lap step
# unrolls over the field, so a D=80 compile takes minutes).
ORACLE_ENGINE_CALL_SIMS = 16_384
ORACLE_ENGINE_CALLS = 16

SEASON_SIMS = 10_000


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def final_line(record: dict) -> str:
    """The script's last stdout line for a device record."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": record["platform"],
            "kind": record["kind"],
            "count": record["count"],
        },
    })


def select_phases(four: bool) -> list[str]:
    """Names of the phases a run executes, in order. The device phase runs
    in both modes: it refuses a non-GPU platform and names the card."""
    if four:
        return ["device", "four"]
    return ["gpu_tests", "device", "engine", "oracle", "season", "serve"]


# -- phase 0 -------------------------------------------------------------------


def junit_counts(xml_path: Path) -> dict:
    """tests/errors/failures/skipped of a pytest junit XML file."""
    root = ET.parse(xml_path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    return {k: int(suite.get(k, 0)) for k in ("tests", "errors", "failures", "skipped")}


def phase_gpu_tests() -> None:
    """The `gpu`-marked tests in a child process. Must run before this
    process imports anything that initializes a JAX backend."""
    with tempfile.TemporaryDirectory() as tmp:
        xml_path = Path(tmp) / "gpu_tests.xml"
        env = {**os.environ, "MCGP_TEST_GPU": "1"}
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", str(REPO / "tests"), "-m", "gpu",
             "-q", "-p", "no:cacheprovider", f"--junitxml={xml_path}"],
            cwd=REPO, env=env,
        ).returncode
        check(rc == 0, f"gpu-marked tests failed (pytest exit code {rc})")
        counts = junit_counts(xml_path)
    say(f"gpu tests: {counts}")
    check(counts["tests"] > 0, "no gpu-marked test was collected")
    check(
        counts["skipped"] == 0 and counts["errors"] == 0 and counts["failures"] == 0,
        f"gpu-marked tests did not all pass: {counts}",
    )


# -- phase 1 -------------------------------------------------------------------


def phase_device(devices) -> dict:
    import importlib.util

    import jax
    import jaxlib

    from monte_carlo_gp.utils.device import query_gpus, require_gpu

    record = require_gpu(devices)
    say(f"device_kind: {record['kind']}  count: {record['count']}")
    raw, _ = query_gpus()
    say("nvidia-smi name, power.limit:")
    for line in raw.splitlines():
        say(line)
    say(f"jax {jax.__version__}  jaxlib {jaxlib.__version__}")
    for mod in ("pandas", "pyarrow"):
        say(f"{mod} importable: {importlib.util.find_spec(mod) is not None}")
    return record


# -- phase 2 -------------------------------------------------------------------


def phase_engine() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmarks.common import standard_params
    from monte_carlo_gp.ops.engine import run_monte_carlo

    params = jax.device_put(standard_params(N_DRIVERS))
    key = jax.device_put(jax.random.PRNGKey(2024))
    race_laps = jnp.int32(RACE_LAPS)

    t0 = time.perf_counter()
    compiled = run_monte_carlo.lower(
        params, key, FULL_SIMS, BUCKET_LAPS, sims_per_block=BLOCK,
        race_laps=race_laps,
    ).compile()
    say(f"engine compile_s: {time.perf_counter() - t0:.3f}")
    say(f"engine memory_analysis: {compiled.memory_analysis()}")

    first = np.asarray(compiled(params, key, race_laps=race_laps).block_until_ready())
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = compiled(params, key, race_laps=race_laps).block_until_ready()
        warm.append(time.perf_counter() - t0)
    say(f"engine warm_s ({FULL_SIMS} sims x {N_DRIVERS} drivers x "
        f"{RACE_LAPS}/{BUCKET_LAPS} laps): {warm}")

    check(first.shape == (N_DRIVERS, N_DRIVERS), f"shape {first.shape}")
    check(bool(np.isfinite(first).all()), "non-finite probabilities")
    row_err = float(np.abs(first.sum(axis=1) - 1).max())
    col_err = float(np.abs(first.sum(axis=0) - 1).max())
    say(f"engine row/col sum error: {row_err:.2e} / {col_err:.2e}")
    check(row_err <= 1e-5 and col_err <= 1e-5, "rows/columns do not sum to 1")
    check(np.array_equal(first, np.asarray(again)), "same key, different result")

    plain = np.asarray(
        run_monte_carlo(params, key, FULL_SIMS, RACE_LAPS, sims_per_block=BLOCK)
    )
    check(
        np.array_equal(first, plain),
        "bucketed run differs from the plain 57-lap scan "
        f"(max |diff| {np.abs(first - plain).max():.3e})",
    )
    say("engine deterministic and bucket-exact (bitwise)")


# -- phase 3 -------------------------------------------------------------------


def oracle_scenario(d: int):
    """The native-oracle anchor scenario of tests/test_engine_stats.py,
    generic in the field size."""
    import numpy as np

    from monte_carlo_gp.config import make_sim_params

    rng = np.random.default_rng(d)
    idx = np.arange(d)
    grid = np.exp(-((idx[None, :] - idx[:, None]) ** 2) / 6.0).astype(np.float32)
    grid /= grid.sum(axis=1, keepdims=True)
    return make_sim_params(
        grid_probs=grid,
        base_pace=(90.0 + 0.06 * idx + 0.05 * rng.standard_normal(d)).astype(np.float32),
        tire_deg=np.clip(0.05 + 0.02 * rng.standard_normal(d), 0.01, 0.15).astype(np.float32),
        variance=np.full(d, 0.15, np.float32),
        dnf_rate=np.full(d, 0.001, np.float32),
        team_dnf_rate=np.full(d, 0.002, np.float32),
        pit_loss=21.0,
        overtake_delta=0.6,
    )


def native_oracle_probs(pool, params, seed: int, n_sims: int, laps: int):
    """Future of the native oracle's (D, D) probabilities over `n_sims`
    sims, split into ORACLE_CHUNKS independently seeded runs on `pool`
    (ctypes releases the GIL while the oracle runs)."""
    from monte_carlo_gp.validate.native_oracle import run_native_oracle

    chunk = n_sims // ORACLE_CHUNKS
    parts = [
        pool.submit(run_native_oracle, params, seed * 1_000 + i, chunk, laps)
        for i in range(ORACLE_CHUNKS)
    ]

    def combine():
        return sum(f.result() for f in parts) / ORACLE_CHUNKS

    return combine


def phase_oracle() -> None:
    import jax
    import numpy as np

    from monte_carlo_gp.ops.engine import run_monte_carlo
    from monte_carlo_gp.validate import native_oracle

    native_oracle._load()  # builds native/liboracle.so; a failed build raises
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        pending = []
        for d, n_oracle, bound in ORACLE_CASES:
            params = oracle_scenario(d)
            pending.append(
                (d, params, bound, native_oracle_probs(pool, params, d, n_oracle, ORACLE_LAPS))
            )
        for d, params, bound, oracle in pending:
            t0 = time.perf_counter()
            key = jax.random.PRNGKey(d)
            engine = sum(
                np.asarray(run_monte_carlo(
                    params, jax.random.fold_in(key, i), ORACLE_ENGINE_CALL_SIMS,
                    ORACLE_LAPS,
                ))
                for i in range(ORACLE_ENGINE_CALLS)
            ) / ORACLE_ENGINE_CALLS
            engine_s = time.perf_counter() - t0
            tv = 0.5 * np.abs(oracle() - engine).sum(axis=1)
            say(f"oracle D={d}: max per-driver TV {tv.max():.5f} (bound {bound}); "
                f"engine {ORACLE_ENGINE_CALLS} x {ORACLE_ENGINE_CALL_SIMS} sims in "
                f"{engine_s:.1f}s (compile included)")
            check(bool(np.isfinite(engine).all()), f"D={d}: non-finite probabilities")
            check(float(tv.max()) < bound, f"D={d}: TV {tv.max():.5f} >= {bound}")


# -- phase 4 -------------------------------------------------------------------


def season_inputs():
    import jax

    from benchmarks.common import standard_params
    from monte_carlo_gp.config import CIRCUITS

    laps = [int(info["laps"]) for info in CIRCUITS.values()]
    return [standard_params(N_DRIVERS)] * len(laps), laps, jax.random.PRNGKey(5)


def phase_season(n_sims: int = SEASON_SIMS) -> None:
    import jax
    import numpy as np

    from monte_carlo_gp.ops.engine import run_monte_carlo
    from monte_carlo_gp.parallel.sharded import simulate_season_sharded

    params_list, laps, key = season_inputs()
    t0 = time.perf_counter()
    probs = simulate_season_sharded(params_list, laps, key, n_sims=n_sims)
    say(f"season: {len(laps)} races x {n_sims} sims in "
        f"{time.perf_counter() - t0:.3f}s (compile included)")
    check(probs.shape == (len(laps), N_DRIVERS, N_DRIVERS), f"shape {probs.shape}")
    check(
        bool(np.allclose(probs.sum(axis=-1), 1.0, atol=1e-5)),
        "season rows do not sum to 1",
    )
    for r in (0, len(laps) - 1):
        solo = np.asarray(run_monte_carlo(
            params_list[r], jax.random.fold_in(key, r), n_sims, laps[r]
        ))
        check(np.array_equal(probs[r], solo),
              f"season race {r} differs from its solo run")
    say("season races match their solo runs (bitwise)")


# -- phase 5 -------------------------------------------------------------------


def phase_serve() -> None:
    from monte_carlo_gp.data.synthetic import SyntheticBackend
    from monte_carlo_gp.models.predictor import F1Predictor
    from monte_carlo_gp.serve import PredictionService

    with tempfile.TemporaryDirectory() as cache:
        predictor = F1Predictor(
            cache_dir=cache, backend=SyntheticBackend(seed=2718)
        )
        service = PredictionService(predictor, safe=False)
        say(f"serve warmup_s: {service.warmup(2024, 'Bahrain'):.3f}")
        driver = service.plan_for(2024, "Bahrain", "fp2").drivers[0]
        plain = {"season": 2024, "race": "Bahrain", "seed": 7}
        penalty = {**plain, "grid_penalties": {driver: 5}}
        answers = [service.predict(req) for req in (plain, plain, penalty)]
    for (status, payload), name in zip(answers, ("plain", "repeat", "penalty")):
        say(f"serve {name}: HTTP {status}, latency_s "
            f"{payload.get('server', {}).get('latency_s')}")
        check(status == 200, f"{name} request answered {status}: {payload}")
        check(not payload.get("fallback"), f"{name} request fell back")
        win = sum(payload["win_probabilities"].values())
        check(abs(win - 1.0) < 1e-3, f"{name}: win probabilities sum to {win}")

    def without_latency(payload):
        return {**payload, "server": {
            k: v for k, v in payload["server"].items() if k != "latency_s"
        }}

    check(
        without_latency(answers[0][1]) == without_latency(answers[1][1]),
        "repeated request gave a different response",
    )


# -- --four ----------------------------------------------------------------------


def phase_four(devices, n_sims: int = FULL_SIMS, season_sims: int = SEASON_SIMS) -> None:
    import jax
    import numpy as np

    from monte_carlo_gp.ops.engine import run_monte_carlo
    from monte_carlo_gp.parallel.mesh import make_mesh, sharded_monte_carlo
    from monte_carlo_gp.parallel.sharded import simulate_season_sharded
    from benchmarks.common import standard_params

    check(len(devices) >= 4, f"--four needs 4 devices, found {len(devices)}")
    four = make_mesh({"sims": 4}, devices=devices[:4])
    one = make_mesh({"sims": 1}, devices=devices[:1])

    params_list, laps, key = season_inputs()
    t0 = time.perf_counter()
    sharded = simulate_season_sharded(params_list, laps, key, n_sims=season_sims, mesh=four)
    say(f"four: season on 4 devices in {time.perf_counter() - t0:.3f}s")
    single = simulate_season_sharded(params_list, laps, key, n_sims=season_sims, mesh=one)
    diff = float(np.abs(sharded - single).max())
    say(f"four: season 4-device vs 1-device max |diff| {diff:.3e}")
    check(np.array_equal(sharded, single), "season: 4-device run differs from 1 device")

    params = standard_params(N_DRIVERS)
    key = jax.random.PRNGKey(11)
    t0 = time.perf_counter()
    multi = np.asarray(sharded_monte_carlo(params, key, n_sims, RACE_LAPS, mesh=four))
    say(f"four: sharded_monte_carlo {n_sims} sims in "
        f"{time.perf_counter() - t0:.3f}s (compile included)")
    solo = np.asarray(run_monte_carlo(params, key, n_sims, RACE_LAPS))  # devices[0]
    diff = float(np.abs(multi - solo).max())
    say(f"four: sharded vs one-device run_monte_carlo max |diff| {diff:.3e}")
    check(np.array_equal(multi, solo), "sharded_monte_carlo differs from one device")


# -- main ------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the four-device comparisons (needs 4 GPUs)",
    )
    args = parser.parse_args(argv)
    phases = select_phases(args.four)

    if "gpu_tests" in phases:
        t0 = time.perf_counter()
        phase_gpu_tests()  # before this process touches JAX
        say(f"phase gpu_tests: ok ({time.perf_counter() - t0:.1f}s)")

    import jax

    devices = jax.devices()
    record = None
    runners = {
        "engine": phase_engine,
        "oracle": phase_oracle,
        "season": phase_season,
        "serve": phase_serve,
        "four": lambda: phase_four(devices),
    }
    for name in phases:
        if name == "gpu_tests":
            continue
        t0 = time.perf_counter()
        if name == "device":
            record = phase_device(devices)
        else:
            runners[name]()
        say(f"phase {name}: ok ({time.perf_counter() - t0:.1f}s)")
    print(final_line(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
