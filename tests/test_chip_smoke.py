"""chip_smoke.py's helpers and its refusals, on the CPU.

The phases themselves need a GPU (`python chip_smoke.py` on the card);
here: the final line, the nvidia-smi parsing, the phase selection of
`--four`, the refusal of a non-GPU platform, and the failure of a copy of
the script that stands without the repo.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from monte_carlo_gp.utils.device import (
    NoGpuError,
    device_record,
    parse_gpu_csv,
    require_gpu,
)

REPO = Path(__file__).resolve().parents[1]


def _devices(platform, kind, count=1):
    return [SimpleNamespace(platform=platform, device_kind=kind)] * count


@pytest.mark.parametrize("count", [1, 4])
def test_final_line_is_the_contract(count):
    record = device_record(_devices("gpu", "NVIDIA H100 80GB HBM3", count))
    line = chip_smoke.final_line(record)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count},
    }


@pytest.mark.parametrize("four, phases", [
    (False, ["gpu_tests", "device", "engine", "oracle", "season", "serve"]),
    (True, ["device", "four"]),
])
def test_select_phases(four, phases):
    assert chip_smoke.select_phases(four) == phases


@pytest.mark.parametrize("text, rows", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]),
    ("NVIDIA H100 80GB HBM3, 400.00 W\n" * 4,
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "400.00 W"}] * 4),
    # a comma inside the name: the power limit is the last field
    ("Card, Rev 2, 350.00 W", [{"name": "Card, Rev 2", "power_limit": "350.00 W"}]),
])
def test_parse_gpu_csv(text, rows):
    assert parse_gpu_csv(text) == rows


@pytest.mark.parametrize("text", ["", "\n", "NVIDIA H100 80GB HBM3", ", 700.00 W"])
def test_parse_gpu_csv_rejects(text):
    with pytest.raises(ValueError):
        parse_gpu_csv(text)


@pytest.mark.parametrize("platform, kind", [("cpu", "cpu"), ("metal", "Apple M2")])
def test_require_gpu_refuses_other_platforms(platform, kind):
    with pytest.raises(NoGpuError, match=platform):
        require_gpu(_devices(platform, kind))


def test_require_gpu_accepts_gpu():
    record = require_gpu(_devices("gpu", "NVIDIA H100 80GB HBM3", 4))
    assert record == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}


def test_four_refuses_cpu_before_any_phase(capsys):
    """`--four` on the CPU: the device phase raises, no `ok` line."""
    with pytest.raises(NoGpuError):
        chip_smoke.main(["--four"])
    assert '"ok"' not in capsys.readouterr().out


def test_junit_counts(tmp_path):
    xml = tmp_path / "r.xml"
    xml.write_text(
        '<?xml version="1.0"?><testsuites><testsuite name="pytest" errors="0" '
        'failures="1" skipped="2" tests="5"></testsuite></testsuites>'
    )
    assert chip_smoke.junit_counts(xml) == {
        "tests": 5, "errors": 0, "failures": 1, "skipped": 2,
    }


@pytest.mark.parametrize("d", [d for d, _, _ in chip_smoke.ORACLE_CASES])
def test_oracle_scenario_is_a_valid_field(d):
    params = chip_smoke.oracle_scenario(d)
    assert params.n_drivers == d
    grid = np.asarray(params.grid_probs)
    np.testing.assert_allclose(grid.sum(axis=1), 1.0, atol=1e-5)


def test_oracle_cases_keep_the_test_bounds():
    """The on-card comparison uses the per-driver TV bounds of
    tests/test_engine_stats.py's native-oracle anchors."""
    assert [(d, bound) for d, _, bound in chip_smoke.ORACLE_CASES] == [
        (20, 0.012), (40, 0.025), (80, 0.04),
    ]


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_script_alone_fails(tmp_path, args):
    """A directory holding chip_smoke.py and nothing else of the repo: the
    script exits non-zero and prints no `ok` line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
