"""What the program runs on: the JAX device record and the card's name and
power limit as `nvidia-smi` reports them.

Every measurement names its device, and a path that measures the GPU
refuses any other platform instead of timing the CPU under a device
metric (bench.py, chip_smoke.py).
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


class NoGpuError(RuntimeError):
    """JAX's default device is not a GPU."""


def device_record(devices) -> dict:
    """{"platform", "kind", "count"} of a `jax.devices()` list."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def require_gpu(devices) -> dict:
    """The device record of `devices`; raises NoGpuError unless the first
    device is a GPU."""
    record = device_record(devices)
    if record["platform"] != "gpu":
        raise NoGpuError(
            f"no GPU: JAX's default device is {record['platform']} "
            f"({record['kind']})"
        )
    return record


def parse_gpu_csv(text: str) -> list[dict]:
    """Rows of `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    -> [{"name": ..., "power_limit": ...}] (power limit as printed, e.g.
    "700.00 W"). Raises ValueError on a line that is not two fields."""
    rows = []
    for line in text.strip().splitlines():
        fields = [f.strip() for f in line.rsplit(",", 1)]
        if len(fields) != 2 or not all(fields):
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        rows.append({"name": fields[0], "power_limit": fields[1]})
    if not rows:
        raise ValueError("nvidia-smi listed no GPU")
    return rows


def query_gpus() -> tuple[str, list[dict]]:
    """(raw output, parsed rows) of the `nvidia-smi` name/power-limit query.
    Raises when nvidia-smi is missing, fails, or prints no card."""
    out = subprocess.run(
        NVIDIA_SMI_QUERY, capture_output=True, text=True, check=True, timeout=60
    ).stdout
    return out.strip(), parse_gpu_csv(out)
