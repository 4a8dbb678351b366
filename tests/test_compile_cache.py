"""Where the persistent compilation cache goes.

JAX_COMPILATION_CACHE_DIR, when set, is used verbatim and the package sets
no other directory; when unset, the cache is the fixed checkout path
`<checkout>/.jax_cache/<host fingerprint>`, the same in every process.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import monte_carlo_gp

REPO = Path(__file__).resolve().parents[1]

_PROBE = (
    "import json, jax, monte_carlo_gp;"
    "print(json.dumps([jax.config.jax_compilation_cache_dir,"
    " jax.config.jax_persistent_cache_min_compile_time_secs,"
    " monte_carlo_gp.compile_cache_dir()]))"
)


def _import_in_child(cache_env: str | None) -> list:
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if cache_env is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = cache_env
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_dir_is_used_verbatim(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/x")
    assert monte_carlo_gp.compile_cache_dir() == "/x"


def test_default_dir_is_the_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(monte_carlo_gp.compile_cache_dir())
    assert path.parent == REPO / ".jax_cache"
    assert path.name == monte_carlo_gp._host_fingerprint()
    assert monte_carlo_gp.compile_cache_dir() == str(path)  # stable across calls


def test_host_fingerprint_is_stable_hex():
    fp = monte_carlo_gp._host_fingerprint()
    assert fp == monte_carlo_gp._host_fingerprint()
    assert len(fp) == 12 and int(fp, 16) >= 0


@pytest.mark.parametrize("cache_env", ["/x", None])
def test_import_sets_the_cache_dir(cache_env):
    """After `import monte_carlo_gp` the JAX config holds the env directory
    verbatim, or the fixed checkout path; the min compile time is set once."""
    cache_dir, min_secs, resolved = _import_in_child(cache_env)
    if cache_env is None:
        assert cache_dir == resolved
        assert Path(cache_dir).parent == REPO / ".jax_cache"
    else:
        assert cache_dir == resolved == cache_env
    assert min_secs == 1.0


def test_default_dir_is_the_same_in_every_process():
    assert _import_in_child(None)[0] == _import_in_child(None)[0]
