"""Starting-grid sampling.

Reproduces the reference's sequential without-replacement draw
(simulation.py:102-145): for each grid slot in order, sample a driver from
the slot's probability column restricted to drivers not yet placed,
renormalizing; fall back to uniform over remaining drivers when the masked
column sums to zero.

Batched formulation: a `lax.scan` over the D grid slots (static trip count).
Each step is a masked Gumbel-max categorical over drivers — exactly
equivalent in distribution to renormalize-then-`np.random.choice`, with no
renormalization needed (Gumbel-max is scale invariant) and no data-dependent
shapes. The whole sampler is batched over the simulation axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = np.float32(-1e30)  # numpy, not jnp: module-level jnp ops eagerly initialize the backend


def sample_grid(
    key: jax.Array,
    grid_probs: jnp.ndarray,
    n_sims: int,
    active: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Sample starting positions for every driver in every simulation.

    Args:
      key: PRNG key (already specialized to the grid stream).
      grid_probs: (D, D) [driver, position] probabilities. Columns need not
        be normalized; negative values are treated as zero.
      n_sims: number of independent grids to draw.
      active: optional (D,) bool mask; inactive drivers are never placed and
        receive position D-1 ... (they simply keep sentinel D).

    Returns:
      (n_sims, D) int32: 0-indexed starting position of each driver.
      Inactive drivers get position D (out of range sentinel).
    """
    d = grid_probs.shape[0]
    if active is None:
        active = jnp.ones((d,), bool)

    # log-probabilities per (driver, position); zeros -> -inf.
    safe = jnp.maximum(grid_probs, 0.0)
    log_probs = jnp.where(safe > 0, jnp.log(jnp.maximum(safe, 1e-38)), NEG_INF)

    def step(carry, pos):
        remaining, start_pos = carry  # (S, D) bool, (S, D) int32
        col = log_probs[:, pos]  # (D,)
        masked = jnp.where(remaining, col[None, :], NEG_INF)  # (S, D)
        # Uniform fallback when every remaining driver has zero probability
        # in this column (reference simulation.py:125-130).
        col_empty = jnp.max(masked, axis=-1, keepdims=True) <= NEG_INF / 2
        logits = jnp.where(col_empty & remaining, 0.0, masked)
        g = jax.random.gumbel(jax.random.fold_in(key, pos), (n_sims, d), jnp.float32)
        winner = jnp.argmax(logits + g, axis=-1)  # (S,)
        any_remaining = jnp.any(remaining, axis=-1)
        onehot = (jnp.arange(d)[None, :] == winner[:, None]) & any_remaining[:, None]
        start_pos = jnp.where(onehot, pos, start_pos)
        remaining = remaining & ~onehot
        return (remaining, start_pos), None

    remaining0 = jnp.broadcast_to(active[None, :], (n_sims, d))
    start0 = jnp.full((n_sims, d), d, jnp.int32)
    (_, start_pos), _ = jax.lax.scan(
        step, (remaining0, start0), jnp.arange(d, dtype=jnp.int32)
    )
    return start_pos
