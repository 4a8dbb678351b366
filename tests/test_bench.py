"""bench.py tests: it measures the GPU or nothing.

Without a GPU, `python bench.py` exits 1 and prints no number (a CPU rate
is not a device metric). With one, it prints one JSON record that names the
device and the card. The record is checked here at a tiny size with a fake
GPU device list; the rate itself comes only from a run on the card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import bench
from monte_carlo_gp.utils import device

REPO = Path(__file__).resolve().parents[1]

FAKE_GPU = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")]
FAKE_SMI = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture
def tiny_bench(monkeypatch):
    """bench.py at 256 sims x 5 laps, nvidia-smi answered by a fixture."""
    monkeypatch.setattr(bench, "N_SIMS", 256)
    monkeypatch.setattr(bench, "TOTAL_LAPS", 5)
    monkeypatch.setattr(bench, "WARM_RUNS", 2)
    monkeypatch.setattr(
        device, "query_gpus", lambda: (FAKE_SMI, device.parse_gpu_csv(FAKE_SMI))
    )


def test_refuses_without_gpu(capsys):
    assert bench.main() == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "GPU only" in captured.err


def test_cli_refuses_without_gpu_end_to_end():
    """The whole script on the CPU: exit code 1 and an empty stdout."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "bench.py"], capture_output=True, text=True,
        timeout=300, env=env, cwd=REPO,
    )
    assert out.returncode == 1, out.stderr[-2000:]
    assert out.stdout == ""


def test_record_fields(tiny_bench):
    rec = bench.measure(FAKE_GPU)
    assert rec["metric"] == bench.METRIC and rec["unit"] == "sims/s"
    assert rec["n_sims"] == 256
    assert rec["value"] > 0 and rec["cold_s"] > 0
    assert rec["vs_baseline"] == pytest.approx(
        rec["value"] / bench.REFERENCE_SIMS_PER_SEC
    )
    assert rec["device"] == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
    }
    assert rec["gpu"] == {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}


def test_main_prints_one_json_line_on_gpu(tiny_bench, monkeypatch, capsys):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: FAKE_GPU)
    assert bench.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["device"]["platform"] == "gpu" and rec["gpu"]["name"]
