"""F1 prediction server: a resident HTTP front-end over PredictionService.

The reference ships only one-shot CLIs (reference main.py:7, backtest.py:8)
— every prediction pays data load + Elo build + features + engine compile
from a cold process. This server is the framework's production-serving
entry point: the predictor and its compiled engine programs stay warm, so
steady-state request latency is Monte-Carlo-only.

    python serve.py --synthetic --port 8000 --simulations 10000 \
        --warm 2024:Bahrain
    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/predict \
        -d '{"season": 2024, "race": "Bahrain", "seed": 7}'

Endpoints:
    GET  /          HTML dashboard (the design doc's planned-but-unshipped
                    app dashboard, plan.md:2340; zero-dependency inline page)
    GET  /healthz   liveness + backend platform
    GET  /stats     request counters (ok / fallbacks / rejected / errors,
                    plan-cache hits/misses)
    POST /predict   JSON request -> the predict_weekend result dict plus a
                    "server" metadata block; same seed => same probabilities
                    (the engine's bitwise reproducibility contract).
    POST /invalidate  evict cached weekend plans ({"season": ..., "race":
                    ..., "prediction_point": ...}, each optional; empty
                    body clears all) -> {"evicted": N}. Weekend plans are
                    also bounded-LRU cached (--plan-cache-size) and
                    optionally re-prepared after --plan-ttl seconds.

A device error while serving answers HTTP 500 with the error text; a
failure while warming a weekend at start-up (other than a weekend with no
usable data) exits the server non-zero.

The HTTP layer is deliberately single-threaded: one device serializes the
Monte Carlo anyway, and the service's own lock guards device access if a
threaded server is ever swapped in. JSON note: full_distributions'
integer position keys serialize as strings (JSON object keys).
"""

import argparse
import json
import signal
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer


def build_predictor(args):
    from monte_carlo_gp.models.predictor import F1Predictor

    backend = None
    if args.synthetic:
        from monte_carlo_gp.data.synthetic import SyntheticBackend

        backend = SyntheticBackend(seed=args.synthetic_seed)
    return F1Predictor(
        cache_dir=args.cache_dir,
        offline=args.offline,
        backend=backend,
        external_elo_cache=args.elo_cache,
        use_elo_cache=args.use_elo_cache or args.offline,
        engine=args.engine,
        rookie_prior=args.rookie_prior,
        quali_model=args.quali_model,
    )


# Largest accepted /predict body. Real requests are a few hundred bytes
# (season/race/seed plus optional penalty/grid dicts over ~20 drivers);
# 1 MiB leaves ~3 orders of magnitude headroom while keeping a hostile
# Content-Length from wedging the single serving thread or ballooning RSS.
MAX_BODY_BYTES = 1 << 20


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        # A stalled client must not wedge the single serving thread forever:
        # socket reads time out and surface as a handled request error.
        timeout = 60

        # Access logs go through the structured logger, not stderr noise.
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, status: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path in ("/", "/dashboard"):
                from monte_carlo_gp.serve import dashboard_html

                body = dashboard_html().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/healthz":
                import jax

                self._reply(200, {
                    "status": "ok",
                    "platform": jax.default_backend(),
                    "requests": service.stats["requests"],
                })
            elif self.path == "/stats":
                self._reply(200, dict(service.stats))
            else:
                self._reply(404, {"error": f"no such endpoint: {self.path}"})

        def do_POST(self):  # noqa: N802 (http.server API)
            if self.path not in ("/predict", "/invalidate"):
                self._reply(404, {"error": f"no such endpoint: {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    self._reply(413, {
                        "error": f"request body too large "
                                 f"({length} > {MAX_BODY_BYTES} bytes)",
                    })
                    return
                request = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"invalid JSON body: {e}"})
                return
            if self.path == "/invalidate":
                if not isinstance(request, dict):
                    self._reply(400, {"error": "body must be a JSON object"})
                    return
                try:
                    season = request.get("season")
                    season = None if season is None else int(season)
                    race = request.get("race")
                    race = None if race is None else str(race)
                    point = request.get("prediction_point")
                    point = None if point is None else str(point)
                except (TypeError, ValueError) as e:
                    self._reply(400, {"error": f"invalid field: {e}"})
                    return
                evicted = service.invalidate(season, race, point)
                self._reply(200, {"evicted": evicted})
                return
            status, payload = service.predict(request)
            self._reply(status, payload)

    return Handler


def main():
    parser = argparse.ArgumentParser(description="F1 Prediction Server")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument(
        "--port", type=int, default=8000,
        help="TCP port (0 picks a free port; the chosen one is printed)",
    )
    parser.add_argument(
        "--simulations", type=int, default=10000,
        help="Default Monte Carlo count per request (requests may override; "
             "each distinct count compiles its own engine program)",
    )
    parser.add_argument(
        # action="extend": a repeated --warm flag adds targets; the default
        # store action with nargs="*" silently REPLACED earlier occurrences.
        "--warm", type=str, nargs="*", action="extend", default=[],
        metavar="SEASON:RACE[:POINT]",
        help="Weekends to prepare + compile before serving "
             "(e.g. 2024:Bahrain 2024:Monaco:quali; flag may repeat)",
    )
    parser.add_argument(
        "--plan-ttl", type=float, default=None, metavar="SECONDS",
        help="Freshness TTL for cached weekend plans: an older plan is "
             "re-prepared on next request so newly-landed session data is "
             "picked up (default: cache forever)",
    )
    parser.add_argument(
        "--plan-cache-size", type=int, default=64,
        help="Max cached weekend plans (LRU eviction beyond this)",
    )
    parser.add_argument(
        "--no-safe", action="store_true",
        help="Return 422 on weekends with no usable data instead of "
             "degrading to uniform fallback predictions",
    )
    parser.add_argument("--offline", action="store_true",
                        help="Serve everything from the local cache")
    parser.add_argument("--cache-dir", type=str, default="./cache")
    parser.add_argument("--elo-cache", type=str, default=None)
    parser.add_argument("--use-elo-cache", action="store_true")
    parser.add_argument("--synthetic", action="store_true",
                        help="Deterministic synthetic data backend (demo)")
    parser.add_argument("--synthetic-seed", type=int, default=2718)
    parser.add_argument("--engine", choices=["auto", "xla"], default="auto")
    parser.add_argument("--rookie-prior", action="store_true")
    parser.add_argument("--quali-model", choices=["elo", "bayesian", "gbm"],
                        default="elo")
    args = parser.parse_args()

    from monte_carlo_gp.serve import PredictionService

    predictor = build_predictor(args)
    service = PredictionService(
        predictor,
        default_simulations=args.simulations,
        safe=not args.no_safe,
        plan_cache_size=args.plan_cache_size,
        plan_ttl_s=args.plan_ttl,
    )

    for spec in args.warm:
        parts = spec.split(":")
        if len(parts) not in (2, 3):
            parser.error(f"--warm expects SEASON:RACE[:POINT], got {spec!r}")
        try:
            season = int(parts[0])
        except ValueError:
            parser.error(
                f"--warm expects SEASON:RACE[:POINT] with an integer season, "
                f"got {spec!r}"
            )
        race = parts[1]
        point = parts[2] if len(parts) == 3 else "fp2"
        from monte_carlo_gp.serve import _VALID_POINTS

        if point not in _VALID_POINTS:
            # A typo'd point would warm a plan-cache entry no request can
            # ever hit (_validate rejects it) — fail fast like the
            # SEASON:RACE parse errors beside it.
            parser.error(
                f"--warm point must be one of {_VALID_POINTS}, got {point!r}"
            )
        try:
            dt = service.warmup(season, race, point)
        except ValueError as e:
            # A typo'd warm target must not turn graceful-degradation
            # deployment into a crash loop: the same weekend requested at
            # runtime would answer with the safe fallback, so warming it is
            # a warning, not a startup failure. Without --no-safe we still
            # fail fast (the operator asked for raw errors).
            if args.no_safe:
                raise
            print(f"warm {season} {race} ({point}) failed: {e}", flush=True)
            continue
        print(f"warm {season} {race} ({point}): {dt:.1f}s", flush=True)

    server = HTTPServer((args.host, args.port), make_handler(service))
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    host, port = server.server_address[:2]
    # Parseable readiness line (tests and orchestrators wait for it).
    print(f"Serving on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
