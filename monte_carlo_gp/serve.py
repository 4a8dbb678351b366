"""Prediction serving: a warm, plan-cached wrapper around `F1Predictor`.

The reference's only entry points are one-shot CLIs (`main.py:7`,
`backtest.py:8`): every prediction pays the full pipeline — data load, Elo
build, feature engineering, engine compile — from a cold process. This
module is the framework's production-serving subsystem (additive; no
reference analogue): a resident `PredictionService` keeps the predictor,
its compiled engine programs, and prepared `WeekendPlan`s warm, so a
repeat prediction request costs only the Monte Carlo itself plus result
assembly, instead of minutes of host prep and compile.

Design notes:
 - Compilation is keyed to (n_simulations, lap bucket, tile/block): the
   service normalizes requests to a fixed default simulation count unless
   the caller overrides it, so steady-state traffic reuses ONE compiled
   program per lap bucket. `warmup()` pre-trips that compile before the
   first request.
 - Weekend plans are host-side (pandas/feature work); they are cached per
   (season, race, prediction_point) in a bounded LRU (`plan_cache_size`)
   with an optional freshness TTL (`plan_ttl_s`) — over a live weekend new
   sessions land on disk, and `prepare_weekend` picks them up on rebuild
   (the loader's frame cache is (path, mtime, size)-keyed), so an expired
   entry re-prepares instead of serving Friday's plan all weekend.
   `invalidate()` (HTTP: POST /invalidate) evicts explicitly. Requests
   carrying grid penalties or an actual grid change the plan, so those
   bypass the cache.
 - Device access is serialized by a lock: JAX dispatch from multiple
   threads interleaves safely but brings no throughput (one device), so the
   HTTP front-end (repo-root `serve.py`) stays single-threaded and the
   lock is a guard, not a scheduler.
 - A device error while serving is a server error (HTTP 500); only a
   weekend with no usable data degrades to the safety fallback.

The HTTP front-end lives at the repo root (`serve.py`) to mirror the
`main.py` / `backtest.py` entry-point layout.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from monte_carlo_gp.config import PENALTY_TYPES
from monte_carlo_gp.models.safety import (
    InsufficientDataError,
    generate_fallback_predictions,
)
from monte_carlo_gp.utils.logging import get_logger, log_event

__all__ = ["PredictionService", "ServeError", "dashboard_html"]

_VALID_POINTS = ("fp1", "fp2", "fp3", "quali", "sprint")


class ServeError(ValueError):
    """A request the service rejects (maps to HTTP 400)."""


def _integral(value, field: str) -> int:
    """Coerce a JSON number to int, rejecting bools and non-integral
    floats (silent truncation of 5.7 grid slots is a client bug)."""
    if isinstance(value, bool):
        raise ServeError(f"{field} values must be integers")
    try:
        as_int = int(value)
    except (TypeError, ValueError, OverflowError):
        # OverflowError: json.loads accepts Infinity, and int(inf) raises
        # it — a client error, not a 500 (or a dropped connection).
        raise ServeError(f"{field} values must be integers")
    if isinstance(value, float) and value != as_int:
        raise ServeError(f"{field} values must be integral (got {value})")
    return as_int


def dashboard_html() -> str:
    """The server's dashboard page (GET /): a zero-dependency HTML client
    for the /predict, /healthz and /stats endpoints.

    The reference design doc plans an `app/streamlit_app.py` dashboard
    (plan.md:2340-2341, tech-stack table plan.md:2311) it never ships;
    Streamlit is unavailable here, so this is a single self-contained page
    (inline CSS/JS, no CDN — the serving host may have zero egress) that
    renders the same prediction report the CLI prints: ranked pole / win /
    podium probability bars plus service stat tiles. Single-series bars,
    zero baseline, values direct-labeled in ink, light/dark via
    prefers-color-scheme."""
    return _DASHBOARD_HTML


_DASHBOARD_HTML = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>F1 Prediction Server</title>
<style>
  :root {
    color-scheme: light;
    --surface: #fcfcfb; --panel: #ffffff; --line: #e4e3df;
    --ink: #0b0b0b; --ink-2: #52514e; --bar: #2a78d6;
  }
  @media (prefers-color-scheme: dark) {
    :root {
      color-scheme: dark;
      --surface: #1a1a19; --panel: #232322; --line: #3a3936;
      --ink: #ffffff; --ink-2: #c3c2b7; --bar: #3987e5;
    }
  }
  body { margin: 0; background: var(--surface); color: var(--ink);
         font: 14px/1.45 system-ui, sans-serif; }
  main { max-width: 980px; margin: 0 auto; padding: 20px; }
  h1 { font-size: 18px; margin: 0 0 4px; }
  .sub { color: var(--ink-2); margin: 0 0 16px; }
  .tiles { display: flex; gap: 10px; flex-wrap: wrap; margin: 0 0 16px; }
  .tile { background: var(--panel); border: 1px solid var(--line);
          border-radius: 8px; padding: 8px 14px; min-width: 90px; }
  .tile b { display: block; font-size: 20px; font-variant-numeric: tabular-nums; }
  .tile span { color: var(--ink-2); font-size: 12px; }
  form { display: flex; gap: 8px; flex-wrap: wrap; align-items: end;
         background: var(--panel); border: 1px solid var(--line);
         border-radius: 8px; padding: 12px; margin: 0 0 16px; }
  label { display: flex; flex-direction: column; gap: 2px;
          color: var(--ink-2); font-size: 12px; }
  input, select { font: inherit; color: var(--ink); background: var(--surface);
          border: 1px solid var(--line); border-radius: 6px; padding: 5px 8px; }
  input[type=number] { width: 90px; }
  button { font: inherit; padding: 6px 16px; border-radius: 6px;
           border: 1px solid var(--line); background: var(--bar);
           color: #fff; cursor: pointer; }
  button:disabled { opacity: .5; cursor: wait; }
  .meta, .err { margin: 0 0 12px; color: var(--ink-2); }
  .err { color: #b3261e; }
  .panels { display: grid; gap: 16px;
            grid-template-columns: repeat(auto-fit, minmax(280px, 1fr)); }
  .panel { background: var(--panel); border: 1px solid var(--line);
           border-radius: 8px; padding: 12px; }
  .panel h2 { font-size: 13px; margin: 0 0 10px; color: var(--ink-2);
              text-transform: uppercase; letter-spacing: .04em; }
  .row { display: grid; grid-template-columns: 44px 1fr 52px; gap: 8px;
         align-items: center; margin-bottom: 2px; padding: 2px 0; }
  .row:hover { background: color-mix(in srgb, var(--bar) 8%, transparent); }
  .drv { font-weight: 600; font-variant-numeric: tabular-nums; }
  .track { height: 12px; }
  .bar { height: 12px; background: var(--bar);
         border-radius: 0 4px 4px 0; min-width: 2px; }
  .val { color: var(--ink-2); text-align: right;
         font-variant-numeric: tabular-nums; }
</style></head><body><main>
  <h1>F1 Prediction Server</h1>
  <p class="sub">Monte Carlo race prediction — resident, compile-warm.
     <span id="health"></span></p>
  <div class="tiles" id="tiles"></div>
  <form id="f">
    <label>Season <input type="number" name="season" value="2024" required></label>
    <label>Race <input name="race" value="Bahrain" required></label>
    <label>Point <select name="prediction_point">
      <option>fp1</option><option selected>fp2</option><option>fp3</option>
      <option>quali</option><option>sprint</option></select></label>
    <label>Simulations <input type="number" name="n_simulations" value="10000"></label>
    <label>Seed <input type="number" name="seed" value="0"></label>
    <button id="go">Predict</button>
  </form>
  <p class="meta" id="meta"></p>
  <p class="err" id="err"></p>
  <div class="panels" id="panels"></div>
<script>
const $ = id => document.getElementById(id);
const pct = p => (100 * p).toFixed(1) + "%";

async function refreshStats() {
  try {
    const [h, s] = await Promise.all([
      fetch("/healthz").then(r => r.json()),
      fetch("/stats").then(r => r.json()),
    ]);
    $("health").textContent = "backend: " + h.platform;
    $("tiles").innerHTML = [
      ["requests", s.requests], ["ok", s.ok], ["fallbacks", s.fallbacks],
      ["rejected", s.rejected], ["errors", s.errors],
      ["plan cache hits", s.plan_cache_hits],
    ].map(([k, v]) => `<div class="tile"><b>${v}</b><span>${k}</span></div>`)
     .join("");
  } catch (e) { $("health").textContent = "stats unavailable"; }
}

function panel(title, probs) {
  const top = Object.entries(probs).sort((a, b) => b[1] - a[1]).slice(0, 10);
  const max = top.length ? top[0][1] : 1;
  const rows = top.map(([d, p]) => `
    <div class="row" title="${d}: ${pct(p)}">
      <span class="drv">${d}</span>
      <div class="track"><div class="bar" style="width:${
        Math.max(100 * p / max, 1).toFixed(1)}%"></div></div>
      <span class="val">${pct(p)}</span>
    </div>`).join("");
  return `<div class="panel"><h2>${title}</h2>${rows}</div>`;
}

$("f").addEventListener("submit", async ev => {
  ev.preventDefault();
  const fd = new FormData(ev.target), body = {};
  for (const [k, v] of fd) body[k] = isNaN(+v) ? v : +v;
  $("go").disabled = true; $("err").textContent = ""; $("meta").textContent = "…";
  try {
    const r = await fetch("/predict", { method: "POST", body: JSON.stringify(body) });
    const j = await r.json();
    if (!r.ok) { $("err").textContent = j.error; $("meta").textContent = ""; }
    else {
      const s = j.server || {};
      $("meta").textContent =
        `${s.season} ${s.race} — ${j.weather && j.weather.rainfall ? "wet" : "dry"}, ` +
        `confidence ${j.confidence}` +
        (j.fallback ? " (FALLBACK: no data)" : "") +
        (s.latency_s != null ? ` — ${(1000 * s.latency_s).toFixed(0)} ms, ` +
         `${s.n_simulations} sims, seed ${s.seed}` : "");
      $("panels").innerHTML =
        panel("Pole position", j.pole_probabilities || {}) +
        panel("Race winner", j.win_probabilities || {}) +
        panel("Podium", j.podium_probabilities || {});
    }
  } catch (e) { $("err").textContent = String(e); $("meta").textContent = ""; }
  $("go").disabled = false;
  refreshStats();
});
refreshStats();
</script></main></body></html>
"""


class PredictionService:
    """Resident predictor + plan cache + request entry point.

    `predict(request)` returns `(status, payload)` where `status` is an
    HTTP status code and `payload` a JSON-serializable dict — transport-
    agnostic so it can sit behind HTTP, a queue, or tests directly.
    """

    def __init__(
        self,
        predictor,
        default_simulations: int = 10_000,
        safe: bool = True,
        max_simulations: int = 4_194_304,
        plan_cache_size: int = 64,
        plan_ttl_s: float | None = None,
    ):
        self.predictor = predictor
        self.default_simulations = int(default_simulations)
        self.max_simulations = int(max_simulations)
        self.safe = safe
        if plan_cache_size < 1:
            raise ValueError("plan_cache_size must be >= 1")
        self.plan_cache_size = int(plan_cache_size)
        self.plan_ttl_s = None if plan_ttl_s is None else float(plan_ttl_s)
        # LRU of (plan, prepared_at_monotonic); bounded so a client looping
        # over distinct weekends cannot grow device+host memory without
        # limit, TTL'd so a resident server re-prepares once newer session
        # data can exist instead of serving the first-request plan forever.
        self._plans: OrderedDict[tuple, tuple[object, float]] = OrderedDict()
        self._lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "ok": 0,
            "fallbacks": 0,
            "rejected": 0,
            "errors": 0,
            "plan_cache_hits": 0,
            "plan_cache_misses": 0,
            "plan_cache_evictions": 0,
        }

    # -- plan cache -----------------------------------------------------------

    def plan_for(self, season: int, race: str, prediction_point: str):
        """Thread-safe public wrapper around the plan cache (takes the
        service lock; `predict`/`warmup` already hold it and use the
        internal variant so a threaded front-end calling `plan_for`
        directly cannot race `invalidate`)."""
        with self._lock:
            return self._plan_for_locked(season, race, prediction_point)

    def _plan_for_locked(self, season: int, race: str, prediction_point: str):
        """Prepared weekend for a bare request, cached per (season, race,
        point) in the bounded LRU (fresh-by-TTL when `plan_ttl_s` is set).
        Caller must hold `self._lock`. Raises InsufficientDataError when
        the data layer is empty."""
        key = (season, race, prediction_point)
        entry = self._plans.get(key)
        if entry is not None:
            plan, prepared_at = entry
            if (
                self.plan_ttl_s is None
                or time.monotonic() - prepared_at < self.plan_ttl_s
            ):
                self._plans.move_to_end(key)
                self.stats["plan_cache_hits"] += 1
                return plan
            # Expired: fall through to a fresh prepare (which re-reads any
            # session files that changed on disk) and replace the entry.
            del self._plans[key]
        self.stats["plan_cache_misses"] += 1
        plan = self.predictor.prepare_weekend(
            season, race, prediction_point=prediction_point
        )
        self._plans[key] = (plan, time.monotonic())
        while len(self._plans) > self.plan_cache_size:
            self._plans.popitem(last=False)
            self.stats["plan_cache_evictions"] += 1
        return plan

    def invalidate(
        self,
        season: int | None = None,
        race: str | None = None,
        prediction_point: str | None = None,
    ) -> int:
        """Evict cached plans matching the given fields (None matches any);
        no arguments clears the whole cache. Returns the eviction count."""
        with self._lock:
            keys = [
                k
                for k in self._plans
                if (season is None or k[0] == season)
                and (race is None or k[1] == race)
                and (prediction_point is None or k[2] == prediction_point)
            ]
            for k in keys:
                del self._plans[k]
        if keys:
            log_event(
                "serve_invalidate", count=len(keys), season=season, race=race,
                prediction_point=prediction_point,
            )
        return len(keys)

    def warmup(self, season: int, race: str, prediction_point: str = "fp2"):
        """Pre-trip the pipeline AND the engine compile for one weekend so
        the first real request is warm. Returns the warmup wall-clock.

        Uses the service's default simulation count — the compile is keyed
        to it, so warming a different count would not help steady traffic.
        """
        t0 = time.perf_counter()
        # Same lock as predict(): warmup may be invoked while serving (an
        # operator re-warming at runtime, or a threaded front-end swap-in),
        # and both the plan cache and the predictor's per-call state
        # (last_effective_sims) must not interleave with a live request.
        with self._lock:
            plan = self._plan_for_locked(season, race, prediction_point)
            self.predictor.simulate_plan(plan, self.default_simulations, seed=0)
        dt = time.perf_counter() - t0
        log_event(
            "serve_warmup", season=season, race=race,
            prediction_point=prediction_point, seconds=round(dt, 3),
        )
        return dt

    # -- request entry point ----------------------------------------------------

    def predict(self, request: dict) -> tuple[int, dict]:
        """Handle one prediction request.

        Request fields: season (int, required), race (str, required),
        prediction_point (default 'fp2'), n_simulations (default the
        service's), seed (default 0), grid_penalties / actual_grid
        (optional dicts; bypass the plan cache).
        """
        self.stats["requests"] += 1
        t0 = time.perf_counter()
        try:
            season, race, point, n_sims, seed, penalties, actual_grid = (
                self._validate(request)
            )
        except ServeError as e:
            self.stats["rejected"] += 1
            return 400, {"error": str(e)}

        try:
            with self._lock:
                if penalties or actual_grid:
                    plan = self.predictor.prepare_weekend(
                        season, race,
                        grid_penalties=penalties,
                        prediction_point=point,
                        actual_grid=actual_grid,
                    )
                else:
                    plan = self._plan_for_locked(season, race, point)
                probs = self.predictor.simulate_plan(plan, n_sims, seed=seed)
                result = self.predictor.assemble_result(plan, probs)
            self.stats["ok"] += 1
        except InsufficientDataError as e:
            if not self.safe:
                self.stats["rejected"] += 1
                return 422, {"error": str(e)}
            # Same degrade contract as safety.safe_predict.
            get_logger().warning("%s, using fallback predictions", e)
            log_event(
                "prediction_fallback", season=season, race=race, reason=str(e)
            )
            result = generate_fallback_predictions(season, race, point)
            self.stats["fallbacks"] += 1
        except Exception as e:  # noqa: BLE001 — a request must never kill the server
            self.stats["errors"] += 1
            get_logger().error("Error predicting %s: %s", race, e)
            log_event("prediction_error", season=season, race=race, reason=str(e))
            return 500, {"error": f"{type(e).__name__}: {e}"}

        dt = time.perf_counter() - t0
        result["server"] = {
            "latency_s": round(dt, 4),
            "n_simulations": n_sims,
            "seed": seed,
            "season": season,
            "race": race,
        }
        log_event(
            "serve_request", season=season, race=race, prediction_point=point,
            n_simulations=n_sims, seed=seed, latency_s=round(dt, 4),
            fallback=bool(result.get("fallback")),
        )
        return 200, result

    # -- validation ---------------------------------------------------------------

    def _validate(self, request: dict):
        if not isinstance(request, dict):
            raise ServeError("request body must be a JSON object")
        try:
            season = int(request["season"])
            race = str(request["race"])
        except (KeyError, TypeError, ValueError):
            raise ServeError("request requires integer 'season' and string 'race'")
        point = request.get("prediction_point", "fp2")
        if point not in _VALID_POINTS:
            raise ServeError(
                f"prediction_point must be one of {list(_VALID_POINTS)}"
            )
        try:
            n_sims = int(request.get("n_simulations", self.default_simulations))
            seed = int(request.get("seed", 0))
        except (TypeError, ValueError):
            raise ServeError("'n_simulations' and 'seed' must be integers")
        if not (0 < n_sims <= self.max_simulations):
            raise ServeError(
                f"n_simulations must be in (0, {self.max_simulations}]"
            )
        if not (-(2**63) <= seed < 2**63):
            # jax.random.PRNGKey overflows outside int64; reject as a
            # client error instead of surfacing a 500.
            raise ServeError("'seed' must fit in a signed 64-bit integer")
        penalties = request.get("grid_penalties") or None
        actual_grid = request.get("actual_grid") or None
        if penalties is not None:
            if not isinstance(penalties, dict):
                raise ServeError("'grid_penalties' must be an object")
            checked = {}
            for d, v in penalties.items():
                # config.resolve_penalty takes positions (ints) or penalty
                # type names (strings). Unknown names resolve to 0 there
                # (a typo'd 'drivethru' would silently apply no penalty)
                # and floats would silently truncate — both are client
                # errors, rejected here.
                if isinstance(v, str):
                    if v not in PENALTY_TYPES:
                        raise ServeError(
                            f"unknown penalty type {v!r}; valid: "
                            f"{sorted(PENALTY_TYPES)}"
                        )
                    checked[str(d)] = v
                else:
                    checked[str(d)] = _integral(v, "'grid_penalties'")
            penalties = checked
        if actual_grid is not None:
            if not isinstance(actual_grid, dict):
                raise ServeError("'actual_grid' must be an object")
            actual_grid = {
                str(d): _integral(p, "'actual_grid'")
                for d, p in actual_grid.items()
            }
        return season, race, point, n_sims, seed, penalties, actual_grid
