"""One engine: `resolve_engine` and the `--engine` choices of every CLI.

The XLA lap-scan engine (ops/engine.py) is the simulator's only engine on
every platform; `auto` and `xla` both select it, and any other name is
refused by the predictor and by the argument parser of each CLI.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from monte_carlo_gp.models.predictor import ENGINES, resolve_engine

REPO = Path(__file__).resolve().parents[1]

CLIS = {
    "main.py": ["main.py"],
    "backtest.py": ["backtest.py"],
    "tune.py": ["tune.py"],
    "serve.py": ["serve.py"],
    "precompile": ["-m", "monte_carlo_gp.precompile"],
}


@pytest.mark.parametrize("name", ["auto", "xla"])
def test_resolve_engine_selects_xla(name):
    assert resolve_engine(name) == "xla"


@pytest.mark.parametrize("name", ["pallas", "cuda", "XLA", ""])
def test_resolve_engine_refuses_unknown(name):
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_engine(name)


def test_engine_names():
    assert ENGINES == ("auto", "xla")


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_engine_choices(cli):
    """`--engine pallas` is an argparse error that lists exactly auto and
    xla as the choices."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, *CLIS[cli], "--engine", "pallas"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 2, out.stderr[-2000:]
    assert "invalid choice: 'pallas'" in out.stderr
    assert re.search(r"\(choose from '?auto'?, '?xla'?\)", out.stderr)
