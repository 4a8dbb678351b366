"""ctypes bindings for the native C++ reference-semantics oracle
(native/oracle.cpp): the sequential ground-truth engine at ~100k sims/s,
enabling tight statistical tolerances when validating the engine.

Builds the shared library on first use (g++, cached next to the source).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from monte_carlo_gp.config import SimParams

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "liboracle.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    src = _NATIVE_DIR / "oracle.cpp"
    if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < src.stat().st_mtime:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
             "-o", str(_LIB_PATH), str(src)],
            check=True,
            capture_output=True,
        )
    lib = ctypes.CDLL(str(_LIB_PATH))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.run_oracle_mut.argtypes = [
        ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        f32p, f32p, f32p, f32p, f32p, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32,
        f32p, f32p, i32p,
        ctypes.c_int32,
        i64p,
    ]
    lib.run_oracle_mut.restype = None
    _lib = lib
    return lib


# Test-only rule mutations (native/oracle.cpp Mutation enum) used to prove
# the statistical tolerances actually detect subtle rule bugs.
MUT_NONE = 0
MUT_NO_FRONT_ROW_START_CLAMP = 1
MUT_NO_TWO_COMPOUND_RULE = 2


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def run_native_oracle(
    params: SimParams, seed: int, n_sims: int, total_laps: int,
    mutation: int = MUT_NONE,
) -> np.ndarray:
    """Run the native sequential oracle; returns (D, D) finish probabilities
    probs[driver, position-1], same contract as `run_monte_carlo`.

    `mutation` applies a deliberate rule defect (MUT_*) — used only by
    mutation-sensitivity tests to prove the tolerances catch such bugs."""
    lib = _load()
    d = params.n_drivers
    counts = np.zeros((d, d), np.int64)
    a32 = lambda x: np.ascontiguousarray(np.asarray(x), np.float32)
    lib.run_oracle_mut(
        ctypes.c_uint64(seed),
        np.int32(n_sims), np.int32(d), np.int32(total_laps),
        a32(params.grid_probs), a32(params.base_pace), a32(params.tire_deg),
        a32(params.variance), a32(params.dnf_rate), a32(params.team_dnf_rate),
        float(params.pit_loss), float(params.overtake_delta),
        float(params.sc_prob), float(params.vsc_prob),
        float(params.red_flag_prob), float(params.drs_delta),
        float(params.dirty_air_threshold), float(params.dirty_air_penalty),
        np.int32(int(params.track_condition)),
        a32(params.compound_pace), a32(params.compound_deg),
        np.ascontiguousarray(np.asarray(params.compound_optimal), np.int32),
        np.int32(mutation),
        counts,
    )
    return counts.astype(np.float64) / n_sims
