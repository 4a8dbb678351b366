"""Central configuration: static F1 data tables and the jit-compatible
simulation parameter pytree.

The data tables reproduce the factual constants of the reference
(`/root/reference/src/config.py:7-120`): 2025 driver→team map, per-team
per-lap DNF rates, tire compound characteristics, circuit parameters, grid
penalty types and the track-type similarity taxonomy. The *representation*
is redesigned for the device: everything that reaches the hot path is
interned to dense integer ids and packed into the `SimParams` pytree so it
can be donated to jit and sharded.
"""

from __future__ import annotations

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Static data tables (reference: src/config.py)
# ---------------------------------------------------------------------------

# 2025 season driver → team mapping (reference config.py:7-28).
DRIVER_TEAMS: dict[str, str] = {
    "VER": "Red Bull",
    "LAW": "Red Bull",
    "NOR": "McLaren",
    "PIA": "McLaren",
    "LEC": "Ferrari",
    "HAM": "Ferrari",
    "RUS": "Mercedes",
    "ANT": "Mercedes",
    "ALO": "Aston Martin",
    "STR": "Aston Martin",
    "GAS": "Alpine",
    "DOO": "Alpine",
    "TSU": "Racing Bulls",
    "HAD": "Racing Bulls",
    "ALB": "Williams",
    "SAI": "Williams",
    "HUL": "Sauber",
    "BOR": "Sauber",
    "OCO": "Haas",
    "BEA": "Haas",
}

# Per-lap DNF probability by team (reference config.py:31-42).
DEFAULT_DNF_RATES: dict[str, float] = {
    "Red Bull": 0.0015,
    "McLaren": 0.0012,
    "Ferrari": 0.0018,
    "Mercedes": 0.0010,
    "Aston Martin": 0.0020,
    "Alpine": 0.0025,
    "Racing Bulls": 0.0022,
    "Williams": 0.0025,
    "Sauber": 0.0028,
    "Haas": 0.0025,
}

# Tire compounds (reference config.py:45-51). Order defines the integer
# encoding used on-device: SOFT=0, MEDIUM=1, HARD=2, INTERMEDIATE=3, WET=4.
TIRE_COMPOUNDS: dict[str, dict[str, float]] = {
    "SOFT": {"pace_delta": -0.8, "deg_rate": 0.08, "optimal_laps": 15},
    "MEDIUM": {"pace_delta": 0.0, "deg_rate": 0.05, "optimal_laps": 25},
    "HARD": {"pace_delta": 0.6, "deg_rate": 0.03, "optimal_laps": 40},
    "INTERMEDIATE": {"pace_delta": 5.0, "deg_rate": 0.02, "optimal_laps": 30},
    "WET": {"pace_delta": 10.0, "deg_rate": 0.01, "optimal_laps": 50},
}

COMPOUND_NAMES: tuple[str, ...] = ("SOFT", "MEDIUM", "HARD", "INTERMEDIATE", "WET")
COMPOUND_IDS: dict[str, int] = {n: i for i, n in enumerate(COMPOUND_NAMES)}
SOFT, MEDIUM, HARD, INTERMEDIATE, WET = range(5)
N_COMPOUNDS = 5
# Bitmask of dry compounds for the mandatory two-dry-compound rule.
DRY_COMPOUND_MASK: int = (1 << SOFT) | (1 << MEDIUM) | (1 << HARD)

# Circuit parameters (reference config.py:54-78).
CIRCUITS: dict[str, dict[str, float]] = {
    "Bahrain": {"laps": 57, "pit_loss": 21.0, "drs_zones": 3, "overtake_delta": 0.6},
    "Saudi Arabia": {"laps": 50, "pit_loss": 20.0, "drs_zones": 3, "overtake_delta": 0.7},
    "Australia": {"laps": 58, "pit_loss": 22.0, "drs_zones": 4, "overtake_delta": 0.5},
    "Japan": {"laps": 53, "pit_loss": 23.0, "drs_zones": 1, "overtake_delta": 1.0},
    "China": {"laps": 56, "pit_loss": 22.0, "drs_zones": 2, "overtake_delta": 0.6},
    "Miami": {"laps": 57, "pit_loss": 21.0, "drs_zones": 3, "overtake_delta": 0.7},
    "Monaco": {"laps": 78, "pit_loss": 24.0, "drs_zones": 1, "overtake_delta": 1.5},
    "Canada": {"laps": 70, "pit_loss": 22.0, "drs_zones": 2, "overtake_delta": 0.6},
    "Spain": {"laps": 66, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.8},
    "Austria": {"laps": 71, "pit_loss": 20.0, "drs_zones": 3, "overtake_delta": 0.5},
    "Great Britain": {"laps": 52, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.7},
    "Hungary": {"laps": 70, "pit_loss": 22.0, "drs_zones": 1, "overtake_delta": 1.2},
    "Belgium": {"laps": 44, "pit_loss": 23.0, "drs_zones": 2, "overtake_delta": 0.5},
    "Netherlands": {"laps": 72, "pit_loss": 20.0, "drs_zones": 2, "overtake_delta": 1.0},
    "Italy": {"laps": 53, "pit_loss": 26.0, "drs_zones": 2, "overtake_delta": 0.4},
    "Azerbaijan": {"laps": 51, "pit_loss": 24.0, "drs_zones": 2, "overtake_delta": 0.5},
    "Singapore": {"laps": 62, "pit_loss": 30.0, "drs_zones": 3, "overtake_delta": 1.1},
    "United States": {"laps": 56, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.7},
    "Mexico": {"laps": 71, "pit_loss": 22.0, "drs_zones": 3, "overtake_delta": 0.6},
    "Brazil": {"laps": 71, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.5},
    "Las Vegas": {"laps": 50, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.6},
    "Qatar": {"laps": 57, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.8},
    "Abu Dhabi": {"laps": 58, "pit_loss": 22.0, "drs_zones": 2, "overtake_delta": 0.7},
}

# Grid penalty types in positions (reference config.py:81-86).
PENALTY_TYPES: dict[str, int] = {
    "engine": 10,
    "full_pu": 20,
    "gearbox": 5,
    "pitlane_start": 20,
}

# Track-type taxonomy for circuit-affinity similarity (reference config.py:91-115).
TRACK_TYPES: dict[str, str] = {
    "Monaco": "street",
    "Singapore": "street",
    "Azerbaijan": "street",
    "Las Vegas": "street",
    "Saudi Arabia": "street",
    "Italy": "high_speed",
    "Belgium": "high_speed",
    "Mexico": "high_speed",
    "Qatar": "high_speed",
    "Hungary": "technical",
    "Spain": "technical",
    "Netherlands": "technical",
    "Japan": "technical",
    "Bahrain": "balanced",
    "Abu Dhabi": "balanced",
    "Australia": "balanced",
    "China": "balanced",
    "Miami": "balanced",
    "Canada": "balanced",
    "Austria": "balanced",
    "Great Britain": "balanced",
    "United States": "balanced",
    "Brazil": "balanced",
}


def get_similar_tracks(track: str) -> list[str]:
    """Tracks sharing this track's type (reference config.py:117-120)."""
    track_type = TRACK_TYPES.get(track, "balanced")
    return [t for t, tt in TRACK_TYPES.items() if tt == track_type and t != track]


# Fallback circuit parameters when a race is not in CIRCUITS
# (reference predictor.py:183-188).
DEFAULT_CIRCUIT: dict[str, float] = {
    "laps": 58,
    "pit_loss": 22.0,
    "drs_zones": 2,
    "overtake_delta": 0.8,
}

# Race-control event rates hardcoded by the reference at predictor.py:59-64.
SC_PROBABILITY = 0.01
VSC_PROBABILITY = 0.015
RED_FLAG_PROBABILITY = 0.002
DRS_DELTA = 0.3

# Track-condition integer encoding used on-device.
DRY, DAMP, FULL_WET = 0, 1, 2
TRACK_CONDITIONS: dict[str, int] = {"dry": DRY, "damp": DAMP, "wet": FULL_WET}


# ---------------------------------------------------------------------------
# SimParams — the jit-compatible simulation parameter pytree
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SimParams:
    """All per-race simulation inputs as dense device arrays.

    Shapes use D = number of grid slots (padded driver axis). Corresponds to
    the reference's `RaceConfig` dataclass plus the per-driver dict arguments
    of `RaceSimulator.run_monte_carlo` (reference simulation.py:37-68).
    `total_laps` is deliberately NOT here — it is a static (compile-time)
    argument of the engine so the lap scan has a fixed trip count.
    """

    # (D, D) [driver, position] qualifying position probabilities.
    grid_probs: jax.Array
    # (D,) per-driver base lap pace in seconds (reference default 90.0).
    base_pace: jax.Array
    # (D,) per-driver tire degradation rate (reference default 0.05).
    tire_deg: jax.Array
    # (D,) per-driver lap-time noise sigma (reference default 0.15).
    variance: jax.Array
    # (D,) resolved per-driver per-lap DNF rate (driver rate, else team rate,
    # else 0.002 — resolution happens at build time; simulation.py:190-197).
    dnf_rate: jax.Array
    # (D,) team per-lap DNF rate — lap 1 uses the TEAM rate ×4 regardless of
    # driver-specific rates (simulation.py:282-284).
    team_dnf_rate: jax.Array
    # (5,) compound pace delta / deg rate / optimal stint length.
    compound_pace: jax.Array
    compound_deg: jax.Array
    compound_optimal: jax.Array
    # Scalars.
    pit_loss: jax.Array
    overtake_delta: jax.Array
    drs_delta: jax.Array
    sc_prob: jax.Array
    vsc_prob: jax.Array
    red_flag_prob: jax.Array
    dirty_air_threshold: jax.Array
    dirty_air_penalty: jax.Array
    # int32 scalar: 0=dry, 1=damp, 2=wet.
    track_condition: jax.Array
    # (D,) bool — False marks padding slots beyond the real entry list.
    active: jax.Array

    @property
    def n_drivers(self) -> int:
        return self.grid_probs.shape[-1]


def make_sim_params(
    *,
    grid_probs: np.ndarray,
    base_pace: np.ndarray,
    tire_deg: np.ndarray,
    variance: np.ndarray,
    dnf_rate: np.ndarray,
    team_dnf_rate: np.ndarray,
    pit_loss: float = 22.0,
    overtake_delta: float = 0.8,
    drs_delta: float = DRS_DELTA,
    sc_prob: float = SC_PROBABILITY,
    vsc_prob: float = VSC_PROBABILITY,
    red_flag_prob: float = RED_FLAG_PROBABILITY,
    dirty_air_threshold: float = 2.0,
    dirty_air_penalty: float = 0.5,
    track_condition: int | str = DRY,
    compound_table: dict[str, dict[str, float]] | None = None,
    active: np.ndarray | None = None,
) -> SimParams:
    """Build a `SimParams` pytree from host-side arrays/scalars."""
    compounds = compound_table or TIRE_COMPOUNDS
    cp = np.array([compounds[n]["pace_delta"] for n in COMPOUND_NAMES], np.float32)
    cd = np.array([compounds[n]["deg_rate"] for n in COMPOUND_NAMES], np.float32)
    co = np.array([compounds[n]["optimal_laps"] for n in COMPOUND_NAMES], np.int32)
    if isinstance(track_condition, str):
        track_condition = TRACK_CONDITIONS[track_condition]
    base_np = np.asarray(base_pace, float)
    d = base_np.shape[0]
    # Engine rank keys are int32-bitcast cumulative times whose injective
    # domain ends at ~5e8 s (ops/ranking.rank_by_unique); capping lap pace at 15,000 s keeps any
    # plausible race (even thousands of laps) far inside it. NaN pace would
    # bitcast to an out-of-domain key and silently corrupt ranks, so
    # finiteness is validated too. Validate HERE, where values are still
    # host-resident numpy — reading a device array back would wait for the
    # device and copy to the host.
    if base_np.size:
        if not np.all(np.isfinite(base_np)):
            raise ValueError(
                "base_pace must be finite (a NaN/inf lap pace would corrupt "
                "the engines' bitcast rank keys)"
            )
        if float(base_np.max()) > 15_000.0:
            raise ValueError(
                f"base_pace up to {float(base_np.max()):.3g}s/lap exceeds "
                "the engines' rank-key domain (real lap times are ~60-120 s)"
            )
        if float(base_np.min()) < 0.0:
            raise ValueError(
                "base_pace must be non-negative (the fused kernel packs the "
                "DRS flag into the pace sign bit; a negative lap pace is "
                "physically meaningless anyway)"
            )
    deg_np = np.asarray(tire_deg, float)
    if deg_np.size and not np.all(np.isfinite(deg_np) & (deg_np >= 0.0)):
        raise ValueError(
            "tire_deg must be finite and non-negative (the reference "
            "clamps it to [0.01, 0.15], features.py:448-490; a negative "
            "or NaN rate would push overtake pace base_pace + age*deg "
            "outside the fused kernel's sign-packed domain and corrupt "
            "the bitcast rank keys)"
        )
    # Every other array that reaches the lap-time sum can smuggle the same
    # NaN into cum_time and corrupt the bitcast rank keys silently.
    for arr_name, arr in (
        ("variance", variance),
        ("dnf_rate", dnf_rate),
        ("team_dnf_rate", team_dnf_rate),
        ("grid_probs", grid_probs),
    ):
        a = np.asarray(arr, float)
        if a.size and not np.all(np.isfinite(a)):
            raise ValueError(
                f"{arr_name} must be finite (NaN/inf would corrupt the "
                "engines' lap times or grid sampling)"
            )
    if active is None:
        active = np.ones((d,), bool)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return SimParams(
        grid_probs=f32(grid_probs),
        base_pace=f32(base_pace),
        tire_deg=f32(tire_deg),
        variance=f32(variance),
        dnf_rate=f32(dnf_rate),
        team_dnf_rate=f32(team_dnf_rate),
        compound_pace=jnp.asarray(cp),
        compound_deg=jnp.asarray(cd),
        compound_optimal=jnp.asarray(co),
        pit_loss=f32(pit_loss),
        overtake_delta=f32(overtake_delta),
        drs_delta=f32(drs_delta),
        sc_prob=f32(sc_prob),
        vsc_prob=f32(vsc_prob),
        red_flag_prob=f32(red_flag_prob),
        dirty_air_threshold=f32(dirty_air_threshold),
        dirty_air_penalty=f32(dirty_air_penalty),
        track_condition=jnp.asarray(track_condition, jnp.int32),
        active=jnp.asarray(active, bool),
    )


def circuit_info(race: str) -> dict[str, float]:
    """Circuit lookup with substring matching for FastF1 event names like
    'Bahrain Grand Prix' (reference predictor.py:165-188)."""
    if race in CIRCUITS:
        return CIRCUITS[race]
    race_lower = race.lower()
    for name, info in CIRCUITS.items():
        if name.lower() in race_lower:
            return info
    return dict(DEFAULT_CIRCUIT)


def resolve_penalty(penalty: int | str) -> int:
    """Penalty type name → grid positions (reference predictor.py:229-233)."""
    if isinstance(penalty, str):
        return PENALTY_TYPES.get(penalty, 0)
    return int(penalty)
