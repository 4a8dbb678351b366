"""Shared benchmark scenario: the BASELINE.md headline shape (20 drivers,
57 laps). This is the SINGLE source of the parameter construction — the
scored `bench.py` (repo root) and every harness in this directory import
this function, so they all measure the exact program the driver scores."""

from __future__ import annotations

import numpy as np


def standard_params(d: int = 20):
    from monte_carlo_gp.config import make_sim_params

    rng = np.random.default_rng(7)
    grid = np.exp(
        -((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 8.0
    ).astype(np.float32)
    grid /= grid.sum(axis=1, keepdims=True)
    return make_sim_params(
        grid_probs=grid,
        base_pace=90.0 + 0.06 * np.arange(d),
        tire_deg=np.clip(0.05 + 0.015 * rng.standard_normal(d), 0.01, 0.15),
        variance=np.full(d, 0.15, np.float32),
        dnf_rate=np.full(d, 0.0008, np.float32),
        team_dnf_rate=np.full(d, 0.002, np.float32),
        pit_loss=21.0,
        overtake_delta=0.6,
    )


def require_gpu() -> dict:
    """The device record of JAX's devices, printed to stderr; raises
    NoGpuError on any other platform, so no harness here times the CPU
    under a device metric."""
    import sys

    import jax

    from monte_carlo_gp.utils.device import require_gpu as _require

    record = _require(jax.devices())
    print(f"device: {record}", file=sys.stderr, flush=True)
    return record


def stage_on_device(params, key, n_keys: int = 4):
    """Host-numpy args re-upload on every call: stage the params and every
    timing key on the device before the timed region."""
    import jax

    params = jax.device_put(params)
    keys = [jax.device_put(jax.random.fold_in(key, i)) for i in range(n_keys)]
    return params, keys
