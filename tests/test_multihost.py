"""Multi-process (multi-'host') dryrun — SURVEY.md §5 distributed backend.

Spawns N separate python processes, each owning ONE CPU device, joined via
`jax.distributed.initialize` with gloo collectives (parallel/distributed.py)
— the hardware-free stand-in for N GPU hosts joined over the network. The sharded
Monte Carlo must produce a histogram BITWISE identical to the
single-process virtual-mesh run: collectives and counter-based seeding
survive process boundaries.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_barrier_is_noop_without_distributed_runtime():
    """`parallel.distributed.barrier` must be callable in single-process
    mode (no jax.distributed client) — library code can call it
    unconditionally between compile and first collective."""
    from monte_carlo_gp.parallel.distributed import barrier

    barrier("not-distributed")  # must not raise


def _run_workers(tmp_path, n_procs: int = 4):
    """Launch N gloo-joined single-device workers; return process-0's saved
    histogram. One retry: on an oversubscribed single-core host,
    coordination-service barriers can time out even with generous limits
    (a scheduling flake, not a correctness property of the code under
    test)."""
    worker = Path(__file__).parent / "multihost_worker.py"

    # Each worker picks its own device count and platform.
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }

    def attempt(out):
        coordinator = f"127.0.0.1:{_free_port()}"
        procs = [
            subprocess.Popen(
                [sys.executable, str(worker), coordinator, str(n_procs),
                 str(i), str(out)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
            for i in range(n_procs)
        ]
        outputs = [p.communicate(timeout=540) for p in procs]
        return [(p.returncode, se.decode()[-2000:]) for p, (so, se) in zip(procs, outputs)]

    out = tmp_path / "mp_probs.npy"
    results = attempt(out)
    if any(rc != 0 for rc, _ in results):
        out = tmp_path / "mp_probs_retry.npy"
        results = attempt(out)
    for rc, err in results:
        assert rc == 0, err
    assert out.exists()
    return np.load(out)


@pytest.mark.slow
def test_multiprocess_sharded_monte_carlo_bitwise(tmp_path):
    """Production shape (20 drivers x 57 laps — the bench shape) across
    REAL process boundaries: 4 gloo-joined single-device workers must
    reproduce the single-process virtual-mesh histogram bitwise."""
    n_procs = 4
    multi = _run_workers(tmp_path, n_procs)

    # single-process reference on the in-process virtual mesh — the SAME
    # params/shape the workers ran (imported, so they cannot drift)
    import jax
    from multihost_worker import N_SIMS, TOTAL_LAPS, dryrun_params

    from monte_carlo_gp.parallel.mesh import make_mesh, sharded_monte_carlo

    params = dryrun_params()
    mesh = make_mesh({"sims": n_procs}, devices=jax.devices()[:n_procs])
    single = np.asarray(
        sharded_monte_carlo(
            params, jax.random.PRNGKey(11), n_sims=N_SIMS,
            total_laps=TOTAL_LAPS, mesh=mesh,
        )
    )
    np.testing.assert_array_equal(multi, single)
