"""Serving layer: PredictionService unit tests + an HTTP end-to-end
subprocess test (serve.py). The reference has no serving surface (its only
entry points are the one-shot CLIs, reference main.py:7 / backtest.py:8);
the contract tested here is the framework's own: same request + same seed
=> byte-identical probabilities, warm plans served from cache, graceful
degradation on empty-data weekends."""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from monte_carlo_gp.data.synthetic import SyntheticBackend
from monte_carlo_gp.models.predictor import F1Predictor
from monte_carlo_gp.serve import PredictionService

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    predictor = F1Predictor(
        cache_dir=tmp_path_factory.mktemp("serve_cache"),
        backend=SyntheticBackend(seed=5, n_events=3),
    )
    return PredictionService(predictor, default_simulations=512)


def test_service_matches_predict_weekend(service, tmp_path):
    status, payload = service.predict(
        {"season": 2024, "race": "Bahrain", "seed": 11, "n_simulations": 512}
    )
    assert status == 200
    # A fresh predictor over the same synthetic world, driven through the
    # one-shot API, must produce byte-identical probabilities.
    direct = F1Predictor(
        cache_dir=tmp_path, backend=SyntheticBackend(seed=5, n_events=3)
    ).predict_weekend(2024, "Bahrain", n_simulations=512, seed=11)
    assert payload["win_probabilities"] == direct["win_probabilities"]
    assert payload["full_distributions"] == direct["full_distributions"]
    assert payload["pole_probabilities"] == direct["pole_probabilities"]
    assert payload["server"]["n_simulations"] == 512
    assert payload["server"]["latency_s"] >= 0


def test_plan_cache_and_determinism(service):
    before = dict(service.stats)
    s1, p1 = service.predict({"season": 2024, "race": "Bahrain", "seed": 3})
    s2, p2 = service.predict({"season": 2024, "race": "Bahrain", "seed": 3})
    assert s1 == s2 == 200
    # Same seed => identical result; the repeat request hits the plan cache.
    assert p1["full_distributions"] == p2["full_distributions"]
    assert service.stats["plan_cache_hits"] >= before["plan_cache_hits"] + 1
    # Different seed => a different draw (almost surely).
    _, p3 = service.predict({"season": 2024, "race": "Bahrain", "seed": 4})
    assert p3["full_distributions"] != p1["full_distributions"]


def test_penalties_bypass_plan_cache(service):
    misses_before = service.stats["plan_cache_misses"]
    hits_before = service.stats["plan_cache_hits"]
    status, payload = service.predict({
        "season": 2024, "race": "Bahrain", "seed": 3,
        "grid_penalties": {"VER": 5},
    })
    assert status == 200
    # A penalty request prepares its own plan: no cache traffic either way.
    assert service.stats["plan_cache_misses"] == misses_before
    assert service.stats["plan_cache_hits"] == hits_before
    assert abs(sum(payload["win_probabilities"].values()) - 1.0) < 1e-3


def test_request_validation(service):
    for bad in (
        {},                                           # missing season/race
        {"season": "x", "race": "Bahrain"},           # non-int season
        {"season": 2024, "race": "Bahrain", "prediction_point": "fp9"},
        {"season": 2024, "race": "Bahrain", "n_simulations": 0},
        {"season": 2024, "race": "Bahrain", "n_simulations": "many"},
        {"season": 2024, "race": "Bahrain", "actual_grid": {"VER": "P1"}},
        {"season": 2024, "race": "Bahrain", "grid_penalties": [5]},
        # In-contract-looking values that would 500 downstream without
        # explicit validation (resolve_penalty TypeError, PRNGKey overflow).
        {"season": 2024, "race": "Bahrain", "grid_penalties": {"VER": None}},
        {"season": 2024, "race": "Bahrain", "grid_penalties": {"VER": [3]}},
        {"season": 2024, "race": "Bahrain", "seed": 2**64},
    ):
        status, payload = service.predict(bad)
        assert status == 400, bad
        assert "error" in payload
    assert service.stats["rejected"] >= 10
    # Client errors must never count as server faults.
    assert service.stats["errors"] == 0


def test_fallback_and_strict_modes(tmp_path):
    # An offline predictor over an empty cache has no data for any weekend.
    predictor = F1Predictor(cache_dir=tmp_path / "empty", offline=True)
    safe = PredictionService(predictor, default_simulations=64, safe=True)
    status, payload = safe.predict({"season": 2024, "race": "Bahrain"})
    assert status == 200
    assert payload["fallback"] is True
    assert payload["confidence"] == "none"
    assert abs(sum(payload["win_probabilities"].values()) - 1.0) < 1e-6
    assert safe.stats["fallbacks"] == 1

    strict = PredictionService(predictor, default_simulations=64, safe=False)
    status, payload = strict.predict({"season": 2024, "race": "Bahrain"})
    assert status == 422
    assert "No practice data" in payload["error"]


def test_plan_cache_lru_bound(tmp_path):
    """The plan cache is bounded: requesting more distinct weekends than
    plan_cache_size evicts the least-recently-used entries instead of
    growing without limit (every synthetic season yields data, so a client
    looping over seasons would otherwise retain a plan per season)."""
    predictor = F1Predictor(
        cache_dir=tmp_path, backend=SyntheticBackend(seed=5, n_events=3)
    )
    svc = PredictionService(
        predictor, default_simulations=64, plan_cache_size=2
    )
    # The three weekends the n_events=3 synthetic world has data for.
    for race in ("Bahrain", "Saudi Arabia", "Australia"):
        status, _ = svc.predict({"season": 2024, "race": race, "seed": 1})
        assert status == 200
    assert len(svc._plans) == 2
    assert svc.stats["plan_cache_evictions"] == 1
    # Bahrain (oldest) was evicted; re-requesting it is a miss...
    misses = svc.stats["plan_cache_misses"]
    svc.predict({"season": 2024, "race": "Bahrain", "seed": 1})
    assert svc.stats["plan_cache_misses"] == misses + 1
    # ...and Australia (most recent) is still a hit.
    hits = svc.stats["plan_cache_hits"]
    svc.predict({"season": 2024, "race": "Australia", "seed": 1})
    assert svc.stats["plan_cache_hits"] == hits + 1


def test_plan_cache_ttl_refreshes(tmp_path):
    """With a TTL set, an expired plan re-prepares on the next request (so
    a resident server picks up session data that landed after the first
    request) and the refreshed result is identical on unchanged data."""
    predictor = F1Predictor(
        cache_dir=tmp_path, backend=SyntheticBackend(seed=5, n_events=3)
    )
    svc = PredictionService(predictor, default_simulations=64, plan_ttl_s=0.0)
    _, p1 = svc.predict({"season": 2024, "race": "Bahrain", "seed": 2})
    misses = svc.stats["plan_cache_misses"]
    _, p2 = svc.predict({"season": 2024, "race": "Bahrain", "seed": 2})
    assert svc.stats["plan_cache_misses"] == misses + 1  # expired -> re-prep
    assert p1["full_distributions"] == p2["full_distributions"]
    assert len(svc._plans) == 1  # replaced, not accumulated


def test_invalidate_evicts_matching_plans(service):
    service.plan_for(2024, "Bahrain", "fp2")
    service.plan_for(2024, "Saudi Arabia", "fp2")
    assert service.invalidate(race="Nowhere") == 0
    assert service.invalidate(season=2024, race="Bahrain") == 1
    misses = service.stats["plan_cache_misses"]
    service.predict({"season": 2024, "race": "Bahrain", "seed": 1})
    assert service.stats["plan_cache_misses"] == misses + 1
    # No-argument invalidate clears everything left.
    assert service.invalidate() >= 1
    assert not service._plans


def test_warmup_prepares_and_compiles(service):
    dt = service.warmup(2024, "Bahrain")
    assert dt >= 0
    # The warmed plan is the cached one.
    hits = service.stats["plan_cache_hits"]
    service.predict({"season": 2024, "race": "Bahrain"})
    assert service.stats["plan_cache_hits"] == hits + 1


# -- HTTP end-to-end ------------------------------------------------------------

ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
    "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
}


def test_dashboard_html_is_self_contained():
    """The dashboard must carry zero external resources (the serving host
    may have no egress): inline CSS/JS only, relative endpoint URLs."""
    from monte_carlo_gp.serve import dashboard_html

    page = dashboard_html()
    assert page.startswith("<!doctype html>")
    assert "https://" not in page and "http://" not in page
    assert "src=" not in page  # no external scripts/images
    for endpoint in ("/predict", "/healthz", "/stats"):
        assert endpoint in page


def _post(url, body, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, timeout=60):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.slow
def test_serve_http_end_to_end(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "serve.py", "--synthetic", "--port", "0",
         "--simulations", "256", "--engine", "xla",
         "--cache-dir", str(tmp_path / "cache"), "--warm", "2024:Bahrain",
         # A typo'd warm target must NOT crash startup in safe mode (the
         # weekend would degrade to the fallback at runtime anyway).
         "--warm", "2024:Nowhere"],
        cwd=REPO, env=ENV, text=True, bufsize=1,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    try:
        # Wait for the parseable readiness line (warmup compiles first).
        base, deadline, startup_lines = None, time.time() + 300, []
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                pytest.fail(f"server died: {proc.stderr.read()[-2000:]}")
            startup_lines.append(line)
            if line.startswith("Serving on "):
                base = line.split("Serving on ", 1)[1].strip()
                break
        assert base, "server never printed its readiness line"
        assert any(
            l.startswith("warm 2024 Nowhere") and "failed:" in l
            for l in startup_lines
        ), startup_lines

        status, health = _get(f"{base}/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["platform"] == "cpu"

        body = {"season": 2024, "race": "Bahrain", "seed": 7}
        s1, r1 = _post(f"{base}/predict", body)
        assert s1 == 200, r1
        assert abs(sum(r1["win_probabilities"].values()) - 1.0) < 1e-3
        assert r1["server"]["n_simulations"] == 256  # server default applied

        # Bitwise reproducibility across requests at the same seed.
        s2, r2 = _post(f"{base}/predict", body)
        assert s2 == 200 and r2["full_distributions"] == r1["full_distributions"]

        status, err = _post(f"{base}/predict", {"race": "Bahrain"})
        assert status == 400 and "season" in err["error"]

        status, stats = _get(f"{base}/stats")
        assert status == 200
        assert stats["ok"] >= 2 and stats["rejected"] >= 1
        assert stats["plan_cache_hits"] >= 2  # warmed plan served both hits

        status, _ = _get(f"{base}/nope")
        assert status == 404

        # Plan invalidation round-trip: evict the warmed Bahrain plan, then
        # a repeat request re-prepares and reproduces the same result.
        status, inv = _post(f"{base}/invalidate", {"race": "Bahrain"})
        assert status == 200 and inv["evicted"] == 1
        s3, r3 = _post(f"{base}/predict", body)
        assert s3 == 200 and r3["full_distributions"] == r1["full_distributions"]
        status, inv = _post(f"{base}/invalidate", {"race": "Nowhere"})
        assert status == 200 and inv["evicted"] == 0
        status, err = _post(f"{base}/invalidate", {"season": "x"})
        assert status == 400

        # A hostile Content-Length is rejected up front (413) without the
        # single serving thread ever trying to read the body.
        import http.client

        hostport = base.split("//", 1)[1]
        host, port = hostport.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        try:
            conn.putrequest("POST", "/predict")
            conn.putheader("Content-Length", str(50_000_000))
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 413, resp.read()
        finally:
            conn.close()

        # Dashboard page (the design doc's planned app dashboard): HTML that
        # drives the same three endpoints this test just exercised.
        with urllib.request.urlopen(f"{base}/", timeout=60) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/html")
            page = r.read().decode()
        assert "F1 Prediction Server" in page
        for marker in ("/predict", "/healthz", "/stats",
                       "Pole position", "Race winner", "Podium"):
            assert marker in page
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()


# -- device errors ------------------------------------------------------------


class _FakeXlaRuntimeError(RuntimeError):
    """Shaped like jaxlib's XlaRuntimeError: a RuntimeError whose message
    carries the status name."""


class _FailingPredictor:
    """Stub predictor whose device stage raises `error`."""

    def __init__(self, error):
        self.simulate_calls = 0
        self.error = error

    def prepare_weekend(self, season, race, prediction_point=None, **kw):
        return ("plan", season, race, prediction_point)

    def simulate_plan(self, plan, n_sims, seed=0):
        self.simulate_calls += 1
        raise self.error

    def assemble_result(self, plan, probs):  # pragma: no cover - never reached
        raise AssertionError("assemble_result after a device error")


def test_non_outage_errors_still_500():
    predictor = _FailingPredictor(ValueError("some unrelated bug"))
    svc = PredictionService(predictor, default_simulations=64)
    status, payload = svc.predict({"season": 2024, "race": "Bahrain"})
    assert status == 500
    assert payload == {"error": "ValueError: some unrelated bug"}
    assert svc.stats["errors"] == 1 and svc.stats["fallbacks"] == 0


@pytest.mark.parametrize("message", [
    "ABORTED: device error (Aborted)",
    "UNAVAILABLE: backend unavailable",
    "RESOURCE_EXHAUSTED: Out of memory while trying to allocate",
    "INTERNAL: CUDA error: an illegal memory access was encountered",
])
def test_device_error_answers_500_without_fallback(message):
    """A device error is a server error: HTTP 500 with the error text, no
    fallback prediction, and the next request touches the device again."""
    predictor = _FailingPredictor(_FakeXlaRuntimeError(message))
    svc = PredictionService(predictor, default_simulations=64)
    for n in (1, 2):
        status, payload = svc.predict({"season": 2024, "race": "Bahrain"})
        assert status == 500
        assert payload == {"error": f"_FakeXlaRuntimeError: {message}"}
        assert "fallback" not in payload
        assert predictor.simulate_calls == n
    assert svc.stats["errors"] == 2 and svc.stats["fallbacks"] == 0


def test_penalty_validation_rejects_unknown_names_and_floats(service):
    for bad_value in ("drivethru", 5.5, True):
        status, payload = service.predict({
            "season": 2024, "race": "Bahrain",
            "grid_penalties": {"VER": bad_value},
        })
        assert status == 400, bad_value
        assert "error" in payload
    # Known names and integral floats stay in-contract.
    for ok_value in ("engine", 5, 5.0):
        status, _ = service.predict({
            "season": 2024, "race": "Bahrain", "n_simulations": 64,
            "grid_penalties": {"VER": ok_value},
        })
        assert status == 200, ok_value
    status, _ = service.predict({
        "season": 2024, "race": "Bahrain",
        "actual_grid": {"VER": 3.7},
    })
    assert status == 400


def test_public_plan_for_is_thread_safe_entry(service):
    # The public plan_for self-locks (ADVICE r4): repeated calls hit the
    # cache and return the same plan object without needing predict().
    p1 = service.plan_for(2024, "Bahrain", "fp2")
    hits = service.stats["plan_cache_hits"]
    p2 = service.plan_for(2024, "Bahrain", "fp2")
    assert p1 is p2
    assert service.stats["plan_cache_hits"] == hits + 1
