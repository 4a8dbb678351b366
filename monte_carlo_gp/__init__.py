"""monte_carlo_gp — stochastic F1 race simulator on JAX/XLA.

A ground-up JAX/XLA rebuild of the capabilities of dan-lee-gh/monte-carlo-gp:
Monte Carlo race simulation (tire degradation, pit stops, safety cars, VSC,
red flags, DRS, overtakes, DNFs), dual qualifying/race Elo ratings, feature
engineering over historical lap archives, weekend prediction orchestration,
and Brier-score backtesting.

Architecture (accelerator-first, not a port):
  - The per-lap simulation loop (reference: serial Python for-loop at
    simulation.py:83) is a `lax.scan` over laps carrying a struct-of-arrays
    car-state pytree of shape (n_sims, n_drivers), batched directly over
    simulations and sharded across devices via `jax.sharding`.
  - All stochastic event draws are counter-based threefry samples
    (`jax_threefry_partitionable=True`), so results are bitwise-reproducible
    per seed under any device sharding.
  - Sorting/position logic becomes rank computations + relational selects
    (no data-dependent control flow, no dot products).
  - Elo updates (reference: elo.py) become a `lax.scan` over a padded event
    tensor with vectorized O(n^2) pairwise expected-score matrices.
  - The data layer is off the hot path (pandas/numpy), emits dense arrays,
    and supports real offline/cached operation (the reference README
    promises this but never implemented it — see SURVEY.md).
"""

import os
from pathlib import Path

import jax

# Bitwise reproducibility of RNG under any sharding: partitionable threefry
# makes jax.random draws independent of the device mesh layout.
jax.config.update("jax_threefry_partitionable", True)


def _host_fingerprint() -> str:
    """Hash of the host's CPU flags. XLA:CPU executables compiled on a host
    with other CPU features load with a "could lead to SIGILL" warning and
    non-identical float codegen (observed to flip Monte Carlo outcomes), so
    the default cache is split per CPU-flags set."""
    import hashlib
    import platform

    probe = platform.machine() + ";" + platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    probe += ";" + line.strip()
                    break
    except OSError:
        pass
    return hashlib.sha256(probe.encode()).hexdigest()[:12]


def compile_cache_dir() -> str:
    """The persistent compilation cache directory: JAX_COMPILATION_CACHE_DIR
    verbatim when set (JAX reads it itself), else the fixed checkout path
    `<checkout>/.jax_cache/<host fingerprint>` — stable across processes, so
    CLI runs, backtests and `precompile` share their compiled programs."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(Path(__file__).resolve().parents[1] / ".jax_cache" / _host_fingerprint())


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# Development-time numeric sanitizer (SURVEY.md §5): MCGP_DEBUG_NANS=1 makes
# any NaN produced under jit raise immediately with a traceback.
if os.environ.get("MCGP_DEBUG_NANS") == "1":
    jax.config.update("jax_debug_nans", True)

__version__ = "0.1.0"
