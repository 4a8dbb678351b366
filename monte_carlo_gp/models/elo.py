"""Dual qualifying/race Elo rating system.

Capability-parity rebuild of the reference's `F1EloSystem`
(/root/reference/src/elo.py): per-driver (quali, race) ratings initialized at
1500, K=32 pairwise round-robin updates per event with deltas computed
against the pre-update snapshot and normalized by (n-1), tie handling (0.5),
clamped expected-score exponent [-10, 10], recency-weighted K (current-season
race-index ramp 0.75->1.5; 1.0/0.7/0.5 for 1/2/3+ year-old data), and a
softmax pole-probability predictor with scale 100.

Array design: ratings live in a dense (n_drivers, 2) array keyed by an
interning table; a single event update is a vectorized O(n^2) pairwise
expected/actual-score matrix; a whole history is one `lax.scan` over a padded
(n_events, n_drivers) tensor (`scan_update`), replacing the reference's
per-event Python double loop (elo.py:45-122).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

QUALI, RACE = 0, 1


@dataclasses.dataclass(frozen=True)
class EloParams:
    k_factor: float = 32.0
    initial_rating: float = 1500.0
    softmax_scale: float = 100.0  # elo.py:135
    exponent_clamp: float = 10.0  # elo.py:42


def recency_k(
    base_k: float, years_ago: float, race_index: int = 0, total_races: int = 24
) -> float:
    """K-factor schedule (reference elo.py:13-38): current season ramps
    0.75x -> 1.5x across the season; older seasons decay 1.0/0.7/0.5."""
    if years_ago <= 0:
        race_weight = 0.75 + (0.75 * race_index / max(1, total_races - 1))
        return base_k * race_weight
    if years_ago <= 1:
        return base_k * 1.0
    if years_ago <= 2:
        return base_k * 0.7
    return base_k * 0.5


def event_update(
    ratings: jax.Array,
    values: jax.Array,
    mask: jax.Array,
    k: jax.Array,
    clamp: float = 10.0,
) -> jax.Array:
    """One pairwise Elo event update, vectorized (reference elo.py:45-122).

    Args:
      ratings: (N,) current ratings for the relevant discipline.
      values: (N,) outcome values; LOWER is better (lap time or position).
      mask: (N,) bool, True for event participants.
      k: scalar K-factor for this event.

    Returns updated (N,) ratings. Events with fewer than 2 participants are
    no-ops (elo.py:52-54). Deltas are computed against the pre-update
    snapshot and applied together, exactly like the reference.
    """
    n = jnp.sum(mask)
    r_i = ratings[:, None]
    r_j = ratings[None, :]
    exponent = jnp.clip((r_j - r_i) / 400.0, -clamp, clamp)
    expected = 1.0 / (1.0 + 10.0**exponent)
    v_i = values[:, None]
    v_j = values[None, :]
    actual = jnp.where(v_i < v_j, 1.0, jnp.where(v_i > v_j, 0.0, 0.5))
    pair = mask[:, None] & mask[None, :] & ~jnp.eye(mask.shape[0], dtype=bool)
    delta = k * jnp.sum(jnp.where(pair, actual - expected, 0.0), axis=1) / jnp.maximum(
        n - 1, 1
    )
    return jnp.where((n >= 2) & mask, ratings + delta, ratings)


@functools.partial(jax.jit, static_argnames=())
def scan_update(
    ratings: jax.Array,
    values: jax.Array,
    masks: jax.Array,
    ks: jax.Array,
    disciplines: jax.Array,
) -> jax.Array:
    """Apply a chronological sequence of events as one `lax.scan`.

    Args:
      ratings: (N, 2) [driver, {quali, race}] ratings.
      values: (E, N) outcome values (lower better), garbage where unmasked.
      masks: (E, N) participant masks.
      ks: (E,) per-event K factors.
      disciplines: (E,) int32, QUALI=0 or RACE=1 — which column updates.

    Returns final (N, 2) ratings.
    """

    def step(r, ev):
        vals, mask, k, disc = ev
        q = event_update(r[:, QUALI], vals, mask, k)
        rc = event_update(r[:, RACE], vals, mask, k)
        new = jnp.stack(
            [jnp.where(disc == QUALI, q, r[:, QUALI]),
             jnp.where(disc == RACE, rc, r[:, RACE])],
            axis=1,
        )
        return new, None

    final, _ = jax.lax.scan(step, ratings, (values, masks, ks, disciplines))
    return final


def softmax_probs(ratings: jax.Array, scale: float = 100.0) -> jax.Array:
    """Pole-probability softmax with max subtraction (reference elo.py:124-141)."""
    scaled = ratings / scale
    scaled = scaled - jnp.max(scaled)
    e = jnp.exp(scaled)
    return e / jnp.sum(e)


class F1EloSystem:
    """Host-side convenience wrapper with the reference's public surface
    (elo.py:6-145) over dense arrays + a driver interning table.

    Incremental `update_*` calls buffer events and flush them through the
    jitted scan in batches; `predict_quali_probs`/`get_rating` force a flush.
    """

    def __init__(self, k_factor: float = 32.0, initial_rating: float = 1500.0):
        self.params = EloParams(k_factor=k_factor, initial_rating=initial_rating)
        self.k = float(k_factor)
        self._names: list[str] = []
        self._ids: dict[str, int] = {}
        self._ratings = np.zeros((0, 2), np.float32)
        self._pending: list[tuple[np.ndarray, np.ndarray, float, int]] = []

    # -- interning ----------------------------------------------------------

    def _intern(self, drivers) -> np.ndarray:
        new = [d for d in drivers if d not in self._ids]
        if new:
            for d in new:
                self._ids[d] = len(self._names)
                self._names.append(d)
            grown = np.full((len(new), 2), self.params.initial_rating, np.float32)
            self._ratings = np.concatenate([self._ratings, grown], axis=0)
        return np.array([self._ids[d] for d in drivers], np.int64)

    @property
    def names(self) -> list[str]:
        return list(self._names)

    # -- reference API ------------------------------------------------------

    def set_recency_weight(
        self, years_ago: float, race_index: int = 0, total_races: int = 24
    ) -> None:
        self.k = recency_k(self.params.k_factor, years_ago, race_index, total_races)

    @staticmethod
    def _normalize_event(results) -> tuple[list[str], np.ndarray]:
        """Accept list[(driver, value)] like the reference, or an ordered
        list[str] (best first) which becomes positions 1..n. The latter fixes
        the reference backtest defect where ordered abbreviation lists raised
        inside elo.py and were silently swallowed (validation.py:191-199,
        SURVEY.md §3.2 warning)."""
        if not results:
            return [], np.zeros((0,), np.float32)
        if isinstance(results[0], str):
            drivers = list(results)
            values = np.arange(1, len(drivers) + 1, dtype=np.float32)
        else:
            drivers = [d for d, _ in results]
            values = np.array([v for _, v in results], np.float32)
        return drivers, values

    def _queue(self, results, discipline: int) -> None:
        """Buffer one event. Duplicate-driver rows collapse to the LAST
        occurrence (dense mask keyed by interned id), whereas the reference
        treats each (driver, value) row as a separate competitor in its
        n(n-1) round-robin and divides by len-1 (elo.py:51-78). Well-formed
        session data never repeats a driver, so this diverges only on
        malformed input — documented as accepted (ADVICE r1)."""
        drivers, values = self._normalize_event(results)
        if len(drivers) < 2:
            return
        ids = self._intern(drivers)
        self._pending.append((ids, values, self.k, discipline))

    def update_quali_ratings(self, quali_results) -> None:
        """(driver, best_lap_time) pairs or ordered driver list (elo.py:45-83)."""
        self._queue(quali_results, QUALI)

    def update_race_ratings(self, race_results) -> None:
        """(driver, finish_position) pairs or ordered driver list (elo.py:85-122)."""
        self._queue(race_results, RACE)

    def flush(self) -> None:
        """Apply buffered events through the jitted scan."""
        if not self._pending:
            return
        n = len(self._names)
        e = len(self._pending)
        values = np.zeros((e, n), np.float32)
        masks = np.zeros((e, n), bool)
        ks = np.zeros((e,), np.float32)
        discs = np.zeros((e,), np.int32)
        for i, (ids, vals, k, disc) in enumerate(self._pending):
            values[i, ids] = vals
            masks[i, ids] = True
            ks[i] = k
            discs[i] = disc
        # The Elo scan is microscopic compute (E<=100 events over N<=40
        # drivers) — pin it to the host CPU backend so it never pays an
        # accelerator compile and launch. A process limited to the GPU
        # (JAX_PLATFORMS=cuda) has no 'cpu' backend at all; fall back to
        # the default device there rather than crash — one small compile,
        # still correct.
        try:
            cpu = jax.local_devices(backend="cpu")[0]
        except RuntimeError:
            cpu = None
        with contextlib.ExitStack() as stack:
            if cpu is not None:
                stack.enter_context(jax.default_device(cpu))
            self._ratings = np.asarray(
                scan_update(
                    jnp.asarray(self._ratings),
                    jnp.asarray(values),
                    jnp.asarray(masks),
                    jnp.asarray(ks),
                    jnp.asarray(discs),
                )
            )
        self._pending.clear()

    def predict_quali_probs(self, drivers: list[str]) -> dict[str, float]:
        """Softmax pole probabilities over `drivers` (elo.py:124-141).

        Computed in NumPy: this is host-side orchestration math over ~20
        scalars — dispatching a single eager op to an accelerator costs
        far more than the computation."""
        if not drivers:
            return {}
        self.flush()
        ratings = np.array(
            [self._rating_of(d, QUALI) for d in drivers], np.float64
        )
        scaled = ratings / self.params.softmax_scale
        e = np.exp(scaled - scaled.max())
        probs = e / e.sum()
        total = probs.sum()
        if total <= 0:
            return {d: 1.0 / len(drivers) for d in drivers}
        return {d: float(p) for d, p in zip(drivers, probs)}

    def _rating_of(self, driver: str, discipline: int) -> float:
        if driver in self._ids:
            return float(self._ratings[self._ids[driver], discipline])
        return self.params.initial_rating

    def has_rating(self, driver: str) -> bool:
        """True once the driver has appeared in any rated (or rookie-
        initialized) event — i.e. `get_rating` would return real history
        rather than the initial-rating default."""
        return driver in self._ids

    def initialize_rookie(
        self, driver: str, team: str | None, driver_teams: dict[str, str] | None = None
    ) -> float:
        """Seed a new driver from a teammate prior (plan.md:2762-2783).

        Prior = mean of the current QUALI ratings of the driver's teammates
        (unknown teammates count at the initial rating, mirroring the spec's
        ``.get('quali', 1500)``), or 1400 when the team has no other drivers
        (conservative default for a new team); both disciplines are set to
        prior - 50 (inexperience penalty). A driver whose team is UNKNOWN
        (``team is None``) is left at the initial rating and NOT interned —
        no information is no reason to demote below the flat default.
        Overwrites any existing rating, exactly like the spec — callers gate
        on `has_rating` when they only want true rookies touched. Returns
        the applied rating.
        """
        return self.initialize_rookies({driver: team}, driver_teams)[driver]

    def initialize_rookies(
        self,
        rookies: dict[str, str | None],
        driver_teams: dict[str, str] | None = None,
    ) -> dict[str, float]:
        """Batch form of `initialize_rookie`: every prior is computed from
        the ratings snapshot BEFORE any of this batch is seeded, so two
        unrated teammates both draw the other at the initial rating instead
        of one seeing the other's freshly penalized rating (the single-call
        loop was order-dependent on the weekend's row order)."""
        self.flush()
        if driver_teams is None:
            from monte_carlo_gp import config as cfg

            driver_teams = cfg.DRIVER_TEAMS
        # Snapshot priors first: _rating_of reads the pre-batch table, and
        # nothing is interned until every prior is fixed.
        applied: dict[str, float] = {}
        for driver, team in rookies.items():
            if team is None:
                applied[driver] = self.params.initial_rating
                continue
            teammates = [
                d for d, t in driver_teams.items() if t == team and d != driver
            ]
            if teammates:
                prior = float(
                    np.mean([self._rating_of(t, QUALI) for t in teammates])
                )
            else:
                prior = 1400.0
            applied[driver] = prior - 50.0
        for driver, team in rookies.items():
            if team is None:
                continue
            (idx,) = self._intern([driver])
            self._ratings[idx, QUALI] = applied[driver]
            self._ratings[idx, RACE] = applied[driver]
        return applied

    def get_rating(self, driver: str, rating_type: str = "quali") -> float:
        """(elo.py:143-145)"""
        self.flush()
        return self._rating_of(driver, QUALI if rating_type == "quali" else RACE)

    # -- persistence hooks (data/elo_cache.py) -------------------------------

    def state_dict(self) -> dict:
        self.flush()
        return {
            "names": list(self._names),
            "ratings": self._ratings.copy(),
            "k_factor": self.params.k_factor,
            "initial_rating": self.params.initial_rating,
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "F1EloSystem":
        sys_ = cls(
            k_factor=float(state.get("k_factor", 32.0)),
            initial_rating=float(state.get("initial_rating", 1500.0)),
        )
        names = list(state["names"])
        sys_._names = names
        sys_._ids = {d: i for i, d in enumerate(names)}
        sys_._ratings = np.asarray(state["ratings"], np.float32).reshape(len(names), 2)
        return sys_
