"""Grid sampler: without-replacement categorical semantics
(reference simulation.py:102-145)."""

import jax
import jax.numpy as jnp
import numpy as np
from scipy import stats

from monte_carlo_gp.ops.grid_sampling import sample_grid


def test_grids_are_permutations():
    d = 20
    gp = np.random.default_rng(0).random((d, d)).astype(np.float32)
    pos = np.asarray(sample_grid(jax.random.PRNGKey(1), jnp.asarray(gp), 256))
    assert pos.shape == (256, d)
    for row in pos:
        assert sorted(row) == list(range(d))


def test_deterministic_grid():
    """A one-hot probability matrix yields exactly that grid every time."""
    d = 8
    perm = np.array([3, 1, 0, 2, 7, 6, 5, 4])
    gp = np.zeros((d, d), np.float32)
    gp[np.arange(d), perm] = 1.0
    pos = np.asarray(sample_grid(jax.random.PRNGKey(0), jnp.asarray(gp), 32))
    np.testing.assert_array_equal(pos, np.tile(perm, (32, 1)))


def test_first_slot_marginal_matches_probs():
    """The slot-0 pick is an exact categorical over column 0."""
    d = 6
    col0 = np.array([0.4, 0.25, 0.15, 0.1, 0.07, 0.03])
    gp = np.tile(col0[:, None] * 0 + 1.0 / d, (1, d)).astype(np.float32)
    gp[:, 0] = col0
    n = 20000
    pos = np.asarray(sample_grid(jax.random.PRNGKey(2), jnp.asarray(gp), n))
    winners = np.argmin(pos, axis=1)  # driver with position 0
    counts = np.bincount(winners, minlength=d)
    chi2 = stats.chisquare(counts, col0 * n)
    assert chi2.pvalue > 1e-4, (counts / n, col0)


def test_uniform_fallback_on_zero_column():
    """When remaining drivers all have zero probability in a column, the
    sampler falls back to uniform over remaining (simulation.py:125-130)."""
    d = 4
    gp = np.zeros((d, d), np.float32)
    gp[0, 0] = 1.0  # driver 0 always on pole; all later columns are zero
    n = 8000
    pos = np.asarray(sample_grid(jax.random.PRNGKey(3), jnp.asarray(gp), n))
    assert (pos[:, 0] == 0).all()
    # slots 1..3 should be uniform over drivers 1..3
    for slot in range(1, d):
        who = np.argmax(pos == slot, axis=1)
        counts = np.bincount(who, minlength=d)[1:]
        chi2 = stats.chisquare(counts, np.full(3, n / 3))
        assert chi2.pvalue > 1e-4, counts


def test_without_replacement_renormalization():
    """Two-driver duel for slot 0; loser must take slot 1 — exercises the
    renormalizing mask. Compare slot-0 marginal to the column ratio."""
    d = 3
    gp = np.array(
        [[0.7, 0.5, 0.0], [0.3, 0.5, 0.0], [0.0, 0.0, 1.0]], np.float32
    )
    n = 20000
    pos = np.asarray(sample_grid(jax.random.PRNGKey(4), jnp.asarray(gp), n))
    assert (pos[:, 2] == 2).all()
    p0_driver0 = (pos[:, 0] == 0).mean()
    assert abs(p0_driver0 - 0.7) < 0.02
