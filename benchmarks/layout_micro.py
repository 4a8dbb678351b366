"""Layout microbenchmark: (D, S) driver-major vs (S, D) sims-major.

Times (a) a pure elementwise op chain and (b) the pairwise rank, in both
layouts, to separate "the layout is slow" from "the rank formulation is
slow". Usage (on a GPU): python benchmarks/layout_micro.py

Each timed call chains REPS dependent applications so per-launch overhead
does not swamp the work. Not measured on the H100.
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

from benchmarks.common import require_gpu  # noqa: E402

D = 20
S = 65_536
REPS = 30


def _time(fn, x, label):
    import jax

    f = jax.jit(fn)
    f(x).block_until_ready()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        times.append(time.perf_counter() - t0)
    per = min(times) / REPS
    print(f"{label:36s} {per * 1e3:8.3f} ms/appl", flush=True)
    return per


def ew_chain(x):
    import jax.numpy as jnp

    for _ in range(REPS):
        x = x * 1.000001 + jnp.float32(0.5)
        x = jnp.maximum(x - 0.25, x * 0.5)
    return x


def rank_dmajor(ikey):
    import jax.numpy as jnp

    for _ in range(REPS):
        r = jnp.sum((ikey[:, None, :] < ikey[None, :, :]).astype(jnp.int32), axis=0)
        ikey = ikey + r
    return ikey


def rank_smajor(ikey):
    import jax.numpy as jnp

    for _ in range(REPS):
        r = jnp.sum(
            (ikey[..., None, :] < ikey[..., :, None]).astype(jnp.int32), axis=-1
        )
        ikey = ikey + r
    return ikey


def main() -> None:
    import jax
    import jax.numpy as jnp

    require_gpu()
    rng = np.random.default_rng(0)
    base = rng.integers(0, 1 << 20, (D, S)).astype(np.int32) * 32
    kd = jax.device_put(jnp.asarray(base + np.arange(D, dtype=np.int32)[:, None]))
    ks = jax.device_put(jnp.asarray((base + np.arange(D, dtype=np.int32)[:, None]).T))
    fd = jax.device_put(jnp.asarray(base, jnp.float32))
    fs = jax.device_put(jnp.asarray(base.T, jnp.float32))

    _time(ew_chain, fd, "elementwise chain (D, S)")
    _time(ew_chain, fs, "elementwise chain (S, D)")
    t_d = _time(rank_dmajor, kd, "rank broadcast (D, S)")
    t_s = _time(rank_smajor, ks, "rank broadcast (S, D)")
    print(f"rank smajor/dmajor: {t_d / t_s:.2f}x", flush=True)


if __name__ == "__main__":
    main()
