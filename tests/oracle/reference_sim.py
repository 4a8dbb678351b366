"""Sequential NumPy oracle of the reference race-engine semantics.

This is an independent reimplementation (NOT a copy) of the behavioral
contract documented in SURVEY.md §2 for /root/reference/src/simulation.py,
used as the ground truth for statistical-tolerance tests of the engine.
It runs one race at a time with plain Python control flow and a local
numpy Generator, mirroring every rule:

  grid sampling (renormalizing without-replacement draw), starting tires by
  condition/grid slot, lap-1 start model with 4x team DNF risk, the
  red->SC->VSC priority chain, dirty air, per-lap DNF/lap-time/fuel/tire
  bookkeeping, pit strategy with the two-dry-compound rule, 3-pass
  cascading overtakes with early break, DRS windows, and the
  finisher/DNF classification order.

RNG draw ORDER differs from the reference (which consumes one global stream
data-dependently); every distribution and decision rule is identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np

COMPOUNDS = ("SOFT", "MEDIUM", "HARD", "INTERMEDIATE", "WET")
COMPOUND_INFO = {
    "SOFT": (-0.8, 0.08, 15),
    "MEDIUM": (0.0, 0.05, 25),
    "HARD": (0.6, 0.03, 40),
    "INTERMEDIATE": (5.0, 0.02, 30),
    "WET": (10.0, 0.01, 50),
}
DRY = {"SOFT", "MEDIUM", "HARD"}


@dataclasses.dataclass
class OracleConfig:
    total_laps: int = 57
    pit_loss: float = 21.0
    overtake_delta: float = 0.6
    sc_prob: float = 0.01
    vsc_prob: float = 0.015
    red_prob: float = 0.002
    drs_delta: float = 0.3
    dirty_air_threshold: float = 2.0
    dirty_air_penalty: float = 0.5
    track_condition: str = "dry"


@dataclasses.dataclass
class Car:
    idx: int
    grid_slot: int
    compound: str
    tire_age: int
    fuel: float = 110.0
    cum: float = 0.0
    last_lap: float = 0.0
    behind_leader: float = 0.0
    drs: bool = False
    dnf: bool = False
    dnf_lap: int = 0
    laps_done: int = 0
    pit_stops: int = 0
    used: set = dataclasses.field(default_factory=set)

    def __post_init__(self):
        self.used.add(self.compound)


def _condition_compound(cond: str, remaining: int) -> str:
    if cond == "wet":
        return "WET"
    if cond == "damp":
        return "INTERMEDIATE"
    if remaining > 30:
        return "HARD"
    if remaining > 15:
        return "MEDIUM"
    return "SOFT"


def sample_grid(rng: np.random.Generator, grid_probs: np.ndarray) -> list[int]:
    """Slot-by-slot renormalizing without-replacement draw over drivers."""
    d = grid_probs.shape[0]
    remaining = set(range(d))
    order = []
    for pos in range(d):
        p = np.array([grid_probs[i, pos] if i in remaining else 0.0 for i in range(d)])
        total = p.sum()
        if total > 0:
            p = p / total
        else:
            p = np.array([1.0 / len(remaining) if i in remaining else 0.0 for i in range(d)])
        p = p / p.sum()
        pick = rng.choice(d, p=p)
        order.append(int(pick))
        remaining.discard(int(pick))
    return order


def simulate_one_race(
    rng: np.random.Generator,
    cfg: OracleConfig,
    grid_order: list[int],
    base_pace: np.ndarray,
    tire_deg: np.ndarray,
    variance: np.ndarray,
    dnf_rate: np.ndarray,
    team_dnf_rate: np.ndarray,
) -> np.ndarray:
    d = len(grid_order)
    cond = cfg.track_condition

    def start_tire(slot):
        if cond == "wet":
            return "WET"
        if cond == "damp":
            return "INTERMEDIATE"
        return "SOFT" if slot < 10 else "MEDIUM"

    cars = [
        Car(
            idx=drv,
            grid_slot=slot,
            compound=start_tire(slot),
            tire_age=(4 if slot < 10 else 0) if cond == "dry" else 0,
        )
        for slot, drv in enumerate(grid_order)
    ]

    def clean_time(c: Car) -> float:
        pace_delta, comp_deg, _ = COMPOUND_INFO[c.compound]
        deg = tire_deg[c.idx]
        factor = deg / 0.05 if deg > 0 else 1.0
        t = (
            base_pace[c.idx]
            + c.tire_age * comp_deg * factor
            - (110.0 - c.fuel) * 0.03
            + pace_delta
            - (cfg.drs_delta if c.drs else 0.0)
            + rng.normal(0, variance[c.idx])
        )
        return t

    def update_positions(lap: int, drs_disabled: bool):
        active = sorted([c for c in cars if not c.dnf], key=lambda c: c.cum)
        for i, c in enumerate(active):
            c.behind_leader = c.cum - active[0].cum
            if lap <= 2 or drs_disabled or i == 0:
                c.drs = False
            else:
                c.drs = (c.cum - active[i - 1].cum) < 1.0

    # ---- lap 1 -------------------------------------------------------------
    for c in cars:
        if rng.random() < team_dnf_rate[c.idx] * 4.0:
            c.dnf, c.dnf_lap = True, 1
            continue
        base_lap = clean_time(c)
        pos = c.grid_slot + 1
        delta = rng.normal(0, min(1.5, 0.5 + pos * 0.1))
        if pos <= 3:
            delta = min(delta, 1.0)
        c.cum += base_lap - delta * 0.5
        c.tire_age += 1
        c.fuel = max(0.0, c.fuel - 1.5)
    update_positions(1, True)

    drs_until = 0
    for lap in range(2, cfg.total_laps + 1):
        # race control
        if rng.random() < cfg.red_prob:
            active = sorted([c for c in cars if not c.dnf], key=lambda c: c.cum)
            leader = active[0].cum if active else 0.0
            remaining = cfg.total_laps - lap
            for i, c in enumerate(active):
                c.cum = leader + i * 0.1
                c.behind_leader = c.cum - leader
                c.tire_age = 0
                c.compound = _condition_compound(cond, remaining)
                c.used.add(c.compound)
            drs_until = lap + 2
        elif rng.random() < cfg.sc_prob:
            active = sorted([c for c in cars if not c.dnf], key=lambda c: c.cum)
            if active:
                leader, llaps = active[0].cum, active[0].laps_done
                for i, c in enumerate(active):
                    down = llaps - c.laps_done
                    c.cum = leader + i * 0.5 + (down * 90.0 if down > 0 else 0.0)
                    c.behind_leader = c.cum - leader
                    c.tire_age = max(0, c.tire_age - 1)
            drs_until = lap + 2
        elif rng.random() < cfg.vsc_prob:
            active = sorted([c for c in cars if not c.dnf], key=lambda c: c.cum)
            if active:
                leader = active[0].cum
                for c in active:
                    c.cum = leader + (c.cum - leader) * 0.8
                    c.behind_leader = c.cum - leader
                if rng.random() < 0.3:
                    for c in active:
                        c.tire_age = max(0, c.tire_age - 1)
            drs_until = lap + 1

        # dirty-air table
        active = sorted([c for c in cars if not c.dnf], key=lambda c: c.cum)
        ahead_lap = {c.idx: active[i - 1].last_lap for i, c in enumerate(active) if i > 0}

        # per-car lap
        for c in cars:
            if c.dnf:
                continue
            if rng.random() < dnf_rate[c.idx]:
                c.dnf, c.dnf_lap = True, lap
                continue
            t = clean_time(c)
            if c.behind_leader > 0:
                a = ahead_lap.get(c.idx, 0.0)
                if a > 0 and c.behind_leader < cfg.dirty_air_threshold:
                    t = max(t + cfg.dirty_air_penalty, a)
            c.cum += t
            c.last_lap = t
            c.tire_age += 1
            c.fuel = max(0.0, c.fuel - 1.5)
            c.laps_done += 1

        # pit stops
        remaining = cfg.total_laps - lap
        for c in cars:
            if c.dnf:
                continue
            _, _, optimal = COMPOUND_INFO[c.compound]
            # f32-precision thresholds: deg==0.05 stored as float32 rounds to
            # 0.0500000007, which must not count as "> 0.05" (matches the f32
            # engine and the reference's double-precision equality).
            deg = np.float32(tire_deg[c.idx])
            if deg > np.float32(0.05):
                optimal = int(optimal * 0.85)
            elif deg < np.float32(0.02):
                optimal = int(optimal * 1.1)
            if c.tire_age > optimal and remaining > 5:
                c.cum += cfg.pit_loss
                new = _condition_compound(cond, remaining)
                used_dry = c.used & DRY
                if len(used_dry) == 1 and new in used_dry and cond == "dry":
                    avail = DRY - used_dry
                    if remaining > 20:
                        new = "MEDIUM" if "MEDIUM" in avail else "HARD"
                    else:
                        new = "SOFT" if "SOFT" in avail else "MEDIUM"
                c.compound = new
                c.used.add(new)
                c.tire_age = 0
                c.pit_stops += 1

        # overtakes: 3 passes, decisions pace-based, sequential time rewrites
        for _ in range(3):
            occurred = False
            order = sorted(cars, key=lambda c: c.cum)
            for i in range(1, d):
                behind, ahead = order[i], order[i - 1]
                if behind.dnf or ahead.dnf:
                    continue
                pb = base_pace[behind.idx] + behind.tire_age * tire_deg[behind.idx]
                pa = base_pace[ahead.idx] + ahead.tire_age * tire_deg[ahead.idx]
                delta = pa - pb + (cfg.drs_delta if behind.drs else 0.0)
                if delta > cfg.overtake_delta:
                    if rng.random() < min(0.5, delta / 2.0):
                        nb = max(0.1, ahead.cum - 0.1)
                        behind.cum = nb
                        ahead.cum = nb + 0.3
                        occurred = True
            if not occurred:
                break

        update_positions(lap, lap <= drs_until)

    # classification
    active = sorted([c for c in cars if not c.dnf], key=lambda c: c.cum)
    dnfs = sorted(
        [c for c in cars if c.dnf], key=lambda c: (c.dnf_lap, c.cum), reverse=True
    )
    result = np.zeros(d, np.int32)
    for i, c in enumerate(active):
        result[c.idx] = i + 1
    for i, c in enumerate(dnfs):
        result[c.idx] = len(active) + i + 1
    return result


def run_oracle_monte_carlo(
    seed: int,
    cfg: OracleConfig,
    grid_probs: np.ndarray,
    base_pace: np.ndarray,
    tire_deg: np.ndarray,
    variance: np.ndarray,
    dnf_rate: np.ndarray,
    team_dnf_rate: np.ndarray,
    n_sims: int,
) -> np.ndarray:
    """Return (D, D) probs[driver, position-1] like the engine."""
    rng = np.random.default_rng(seed)
    d = grid_probs.shape[0]
    counts = np.zeros((d, d), np.int64)
    for _ in range(n_sims):
        grid = sample_grid(rng, grid_probs)
        res = simulate_one_race(
            rng, cfg, grid, base_pace, tire_deg, variance, dnf_rate, team_dnf_rate
        )
        for drv in range(d):
            counts[drv, res[drv] - 1] += 1
    return counts / n_sims
