"""Microbenchmark: rank/permute primitive formulations in driver-major layout.

Times candidate formulations of the two hottest ranking primitives
(ops/ranking.py) in isolation at the production shape ((D=20, S=65536)
f32) so layout decisions are measured, not assumed:

  rank:    unrolled row-slice loop  vs  (D, D, S) broadcast-compare-reduce
  scatter: unrolled eq/where chain  vs  one-hot matmul contraction

Usage (on a GPU): python benchmarks/rank_micro.py

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
REPS = 30  # chain REPS dependent applications per timed call


def _time(fn, x, label):
    import jax

    f = jax.jit(fn)
    f(x).block_until_ready()  # compile
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        times.append(time.perf_counter() - t0)
    per = min(times) / REPS
    print(f"{label:34s} {per * 1e3:8.3f} ms/appl "
          f"({S / per / 1e6:8.1f}M lanes/s)", flush=True)
    return per


def rank_unrolled(ikey):
    import jax.numpy as jnp

    r = jnp.zeros(ikey.shape, jnp.int32)
    for j in range(D):
        r += (ikey[j : j + 1, :] < ikey).astype(jnp.int32)
    return r


def rank_bcast(ikey):
    import jax.numpy as jnp

    # (D_j, D_i, S): sum over j (axis 0) of [k_j < k_i]
    return jnp.sum(
        (ikey[:, None, :] < ikey[None, :, :]).astype(jnp.int32), axis=0
    )


def scatter_unrolled(values, rank):
    import jax.numpy as jnp

    pos = jnp.arange(D, dtype=jnp.int32)[:, None]
    out = jnp.zeros_like(values)
    for c in range(D):
        eq = rank[c : c + 1, :] == pos
        out = jnp.where(eq, values[c : c + 1, :], out)
    return out


def scatter_onehot(values, rank):
    import jax.numpy as jnp

    pos = jnp.arange(D, dtype=jnp.int32)
    onehot = (rank[:, None, :] == pos[None, :, None]).astype(values.dtype)
    return jnp.einsum("cps,cs->ps", onehot, values)


def main() -> None:
    import jax
    import jax.numpy as jnp

    require_gpu()
    rng = np.random.default_rng(0)
    k0 = jax.device_put(
        jnp.asarray(rng.integers(0, 1 << 20, (D, S)), jnp.int32) * 32
        + jnp.arange(D, dtype=jnp.int32)[:, None]
    )

    def chain(rank_fn):
        def f(ikey):
            for _ in range(REPS):
                r = rank_fn(ikey)
                ikey = ikey + r  # data dependence between applications
            return ikey

        return f

    t_u = _time(chain(rank_unrolled), k0, "rank: unrolled row-slice loop")
    t_b = _time(chain(rank_bcast), k0, "rank: (D,D,S) broadcast-reduce")
    print(f"rank speedup bcast/unrolled: {t_u / t_b:.2f}x", flush=True)

    v0 = jax.device_put(jnp.asarray(rng.standard_normal((D, S)), jnp.float32))

    def sch(scatter_fn):
        def f(values):
            r = rank_unrolled(k0)
            for _ in range(REPS):
                values = scatter_fn(values, r) + 1.0
            return values

        return f

    s_u = _time(sch(scatter_unrolled), v0, "scatter: unrolled eq/where")
    s_o = _time(sch(scatter_onehot), v0, "scatter: one-hot matmul")
    print(f"scatter speedup onehot/unrolled: {s_u / s_o:.2f}x", flush=True)


if __name__ == "__main__":
    main()
