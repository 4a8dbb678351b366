"""Unit tests for the rank/permutation primitives (ops/ranking.py)."""

import jax.numpy as jnp
import numpy as np

import pytest

from monte_carlo_gp.ops.ranking import (
    gather_at_rank,
    rank_by,
    rank_by_unique,
    scatter_by_rank,
    value_of_car_ahead,
)


def test_rank_matches_stable_argsort():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 20)).astype(np.float32)
    ranks = np.asarray(rank_by(jnp.asarray(x)))
    expected = np.argsort(np.argsort(x, axis=-1, kind="stable"), axis=-1)
    np.testing.assert_array_equal(ranks, expected)


@pytest.mark.parametrize("d", [20, 40, 80, 128, 150])
def test_rank_by_unique_tiers_match_stable_argsort(d):
    """Every packing tier — (Q=2,M=32), (Q=3,M=64), (Q=4,M=128) — and the
    >128 exact-lexicographic fallback must reproduce stable-argsort ranks
    on race-scale keys separated well beyond the 2^Q-ULP quantization
    bucket, with DNF'd cars sorting last."""
    rng = np.random.default_rng(d)
    # spacing >= 0.05 s at ~4e3 s: >> 16 ULP (~0.004 s), so quantization
    # never reorders; ties are impossible by construction
    x = (4000.0 + np.cumsum(rng.uniform(0.05, 3.0, (16, d)), axis=-1)).astype(
        np.float32
    )
    perm = rng.permuted(np.broadcast_to(np.arange(d), (16, d)), axis=-1)
    x = np.take_along_axis(x, perm, axis=-1)
    dnf = rng.uniform(size=(16, d)) < 0.2
    ranks = np.asarray(rank_by_unique(jnp.asarray(x), jnp.asarray(dnf)))
    masked = np.where(dnf, np.float32(1e30), x)
    expected = np.argsort(np.argsort(masked, axis=-1, kind="stable"), axis=-1)
    np.testing.assert_array_equal(ranks, expected)


@pytest.mark.parametrize("d", [2, 32, 33, 64, 65, 128, 129])
def test_rank_by_unique_equals_rank_by_at_tier_edges(d):
    """At each edge of the packing tiers, `rank_by_unique` gives exactly
    the ranks of the lexicographic `rank_by` over the same keys with DNF'd
    cars moved last, exact ties arbitrating by index in both."""
    rng = np.random.default_rng(1000 + d)
    x = (3000.0 + np.cumsum(rng.uniform(0.05, 2.0, (32, d)), axis=-1)).astype(
        np.float32
    )
    x = rng.permuted(x, axis=-1)
    x[:4, : d // 2] = x[:4, :1]  # exact ties
    dnf = rng.uniform(size=(32, d)) < 0.2
    unique = np.asarray(rank_by_unique(jnp.asarray(x), jnp.asarray(dnf)))
    reference = np.asarray(rank_by(jnp.asarray(np.where(dnf, np.float32(1e30), x))))
    np.testing.assert_array_equal(unique, reference)


def test_rank_tie_break_by_index():
    x = jnp.asarray([[1.0, 0.0, 1.0, 0.0]])
    np.testing.assert_array_equal(np.asarray(rank_by(x)), [[2, 0, 3, 1]])


def test_scatter_gather_roundtrip():
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((8, 20)).astype(np.float32)
    keys = rng.standard_normal((8, 20)).astype(np.float32)
    rank = rank_by(jnp.asarray(keys))
    sorted_vals = scatter_by_rank(jnp.asarray(vals), rank)
    # position p holds the value of the car with rank p
    for s in range(8):
        order = np.argsort(keys[s], kind="stable")
        np.testing.assert_allclose(np.asarray(sorted_vals)[s], vals[s][order], rtol=1e-6)
    back = gather_at_rank(sorted_vals, rank)
    np.testing.assert_allclose(np.asarray(back), vals, rtol=1e-6)


def test_scatter_int_and_bool_dtypes():
    keys = jnp.asarray([[3.0, 1.0, 2.0]])
    rank = rank_by(keys)  # [2, 0, 1]
    ints = scatter_by_rank(jnp.asarray([[10, 20, 30]], jnp.int32), rank)
    np.testing.assert_array_equal(np.asarray(ints), [[20, 30, 10]])
    assert ints.dtype == jnp.int32


def test_value_of_car_ahead():
    keys = jnp.asarray([[5.0, 1.0, 3.0]])  # ranks: [2, 0, 1]
    vals = jnp.asarray([[50.0, 10.0, 30.0]])
    ahead = value_of_car_ahead(vals, rank_by(keys), fill=-1.0)
    # car 1 leads -> fill; car 2 is behind car 1 -> 10; car 0 behind car 2 -> 30
    np.testing.assert_allclose(np.asarray(ahead), [[30.0, -1.0, 10.0]])
