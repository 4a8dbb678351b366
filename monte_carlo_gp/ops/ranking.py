"""Rank and permutation primitives over the (small, static) driver axis.

The reference engine calls Python `sorted()` on car lists several times per
lap (simulation.py:179, :506, :549). Here every sort becomes:

  * `rank_by`    — O(D^2) pairwise comparison ranks (ties broken by index,
                   matching Python's stable sort over list order),
  * `scatter_by_rank` / `gather_at_rank` — one-hot permutation contractions
                   that move values between car-indexed and position-indexed
                   layouts without gather/scatter engines.

D (number of drivers / grid slots) is ~20, so the D×D one-hot contractions
are trivially cheap, fully vectorized over the simulation batch, and contain
no data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_IKEY_BASE = 0x3E800000  # bitcast(0.25f)
_IKEY_FLOOR = 0.25  # keys clamp here first: sub-floor values tie -> index
_DNF_KEY_BASE = 2_100_000_000


def rank_by_unique(keys: jnp.ndarray, dnf: jnp.ndarray | None = None) -> jnp.ndarray:
    """`rank_by` for non-negative f32 time keys, ~2.5x cheaper.

    Builds strictly-unique int32 keys via the monotone f32 bit pattern —
    ((bitcast(max(k, 0.25)) - bitcast(0.25)) >> Q) * M + index — so the
    pairwise comparison needs ONE compare instead of the three-op
    lexicographic tie-break (the (..., D, D) comparison tensor is the lap
    step's largest intermediate). The packing widens with the field:
    (Q=2, M=32) up to 32 rows (the original layout — every D<=32 result
    stays bitwise unchanged), (Q=3, M=64) for 33..64, and (Q=4, M=128)
    for 65..128; every tier scales
    quantized keys by M >> Q = 8, so the int32 headroom is identical.
    Exact f32 ties, pairs within 2^Q ULP (≈4-16 ms at race scale), and
    values below 0.25 s arbitrate by index — the same arbitration `rank_by`
    applies to exact ties, validated against the native oracle at 262k sims
    (sub-noise-floor TV).
    Exact-ordering domain: [0.25, ~5e8) s — make_sim_params caps lap pace
    at 15,000 s, keeping any plausible race orders of magnitude inside.
    `dnf` marks cars that sort last (distinct keys)."""
    d = keys.shape[-1]
    if d > 128:
        # the *M+index packing is only injective for <=128 rows; rare
        # oversize fields take the exact lexicographic path instead
        masked = keys if dnf is None else jnp.where(dnf, jnp.float32(1e30), keys)
        return rank_by(masked)
    q_shift, row_mult = (2, 32) if d <= 32 else ((3, 64) if d <= 64 else (4, 128))
    idx = jnp.arange(d, dtype=jnp.int32)
    bits = jax.lax.bitcast_convert_type(jnp.maximum(keys, _IKEY_FLOOR), jnp.int32)
    ikey = ((bits - _IKEY_BASE) >> q_shift) * row_mult + idx
    if dnf is not None:
        ikey = jnp.where(dnf, _DNF_KEY_BASE + idx, ikey)
    a = ikey[..., :, None]
    b = ikey[..., None, :]
    return jnp.sum(b < a, axis=-1, dtype=jnp.int32)


def rank_by(keys: jnp.ndarray) -> jnp.ndarray:
    """Dense competition ranks of `keys` along the last axis, ascending.

    rank_i = #{ j : k_j < k_i  or  (k_j == k_i and j < i) }

    Ties broken by index, which reproduces Python's stable `sorted()` over a
    list held in index order. Works for any leading batch dims. Returns int32
    — always an exact permutation of 0..D-1.
    """
    a = keys[..., :, None]  # i axis
    b = keys[..., None, :]  # j axis
    d = keys.shape[-1]
    idx = jnp.arange(d, dtype=jnp.int32)
    before = (b < a) | ((b == a) & (idx[None, :] < idx[:, None]))
    return jnp.sum(before, axis=-1, dtype=jnp.int32)


def scatter_by_rank(values: jnp.ndarray, rank: jnp.ndarray) -> jnp.ndarray:
    """Reorder car-indexed `values` into position-indexed order.

    out[..., p] = values of the car whose rank is p. `rank` must be a
    permutation (as produced by `rank_by`).

    Implemented as an unrolled relational select over the D cars: each step
    is an elementwise (..., D) where, so XLA fuses the whole permutation
    without materializing a (..., D, D) one-hot (the einsum formulation
    round-trips ~3x the state through HBM).
    """
    d = rank.shape[-1]
    pos = jnp.arange(d, dtype=jnp.int32)
    out = jnp.zeros_like(values)
    for c in range(d):
        # car c lands at position rank[..., c]
        out = jnp.where(rank[..., c : c + 1] == pos, values[..., c : c + 1], out)
    return out


def gather_at_rank(sorted_values: jnp.ndarray, rank: jnp.ndarray) -> jnp.ndarray:
    """Inverse of `scatter_by_rank`: read position-indexed values back to cars.

    out[..., c] = sorted_values[..., rank[c]].
    """
    d = rank.shape[-1]
    pos = jnp.arange(d, dtype=jnp.int32)
    out = jnp.zeros_like(sorted_values)
    for p in range(d):
        # position p's value goes to every car whose rank is p (exactly one)
        out = jnp.where(rank == p, sorted_values[..., p : p + 1], out)
    return out


def value_of_car_ahead(
    values: jnp.ndarray, rank: jnp.ndarray, fill: float = 0.0
) -> jnp.ndarray:
    """For each car, the `values` entry of the car one rank ahead of it.

    Rank-0 cars (the leader) get `fill`. This is the vectorized form of the
    reference's car-ahead lookups (dirty air at simulation.py:179-183, DRS
    gap at :556-559, overtake pairs at :508-512).
    """
    by_pos = scatter_by_rank(values, rank)
    ahead = jnp.concatenate(
        [jnp.full(by_pos.shape[:-1] + (1,), fill, by_pos.dtype), by_pos[..., :-1]],
        axis=-1,
    )
    return gather_at_rank(ahead, rank)
