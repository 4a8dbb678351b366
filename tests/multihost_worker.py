"""One 'host' of the multi-process dryrun (tests/test_multihost.py).

Each worker owns ONE CPU device and joins a gloo-backed jax.distributed
runtime; together the N workers form the same 'sims'-axis mesh N hosts
would, and run the sharded Monte Carlo. Process 0 writes the histogram,
which must be BITWISE identical to a single-process run of the same
(key, n_sims) — counter-based draws make the math process-layout-blind.

Usage: python multihost_worker.py <coordinator> <num_procs> <proc_id> <out.npy>
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

# Production shape (VERDICT r3 #7): the full 20-driver field over the
# 57-lap Bahrain-length race — the same shape the bench and the
# single-process realistic dryrun use — with a modest sim count so four
# oversubscribed CPU workers still finish inside the test timeout.
D_DRIVERS = 20
TOTAL_LAPS = 57
N_SIMS = 1024


def dryrun_params():
    """The exact SimParams both the workers and the single-process
    reference run — importable so the bitwise assertion can never drift."""
    import numpy as np

    from monte_carlo_gp.config import make_sim_params

    d = D_DRIVERS
    gp = np.exp(
        -((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 6.0
    ).astype(np.float32)
    gp /= gp.sum(1, keepdims=True)
    return make_sim_params(
        grid_probs=gp,
        base_pace=90 + 0.06 * np.arange(d),
        tire_deg=np.full(d, 0.05),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.001),
        team_dnf_rate=np.full(d, 0.002),
        pit_loss=21.0,
        overtake_delta=0.6,
    )


def main(coordinator: str, num_procs: int, proc_id: int, out_path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    from monte_carlo_gp.parallel.distributed import initialize_distributed

    assert initialize_distributed(
        coordinator_address=coordinator,
        num_processes=num_procs,
        process_id=proc_id,
        platform="cpu",
    )

    import jax
    import numpy as np

    jax.config.update("jax_threefry_partitionable", True)
    assert len(jax.devices()) == num_procs, jax.devices()
    assert len(jax.local_devices()) == 1

    from monte_carlo_gp.parallel.mesh import make_mesh

    params = dryrun_params()
    mesh = make_mesh({"sims": num_procs})
    key = jax.random.PRNGKey(11)
    # AOT-compile, rendezvous, THEN execute: the first execution creates the
    # gloo communicators, whose rendezvous gives up after ~30 s — far less
    # than cross-process compile skew on a cold cache (see
    # parallel/distributed.barrier). sharded_monte_carlo == _sharded_probs
    # under set_mesh (mesh.py:87-88).
    from monte_carlo_gp.parallel.distributed import barrier
    from monte_carlo_gp.parallel.mesh import _sharded_probs

    with jax.set_mesh(mesh):
        compiled = _sharded_probs.lower(
            params, key, N_SIMS, TOTAL_LAPS, mesh, "sims"
        ).compile()
        barrier("mcgp_worker_compiled")
        probs = compiled(params, key)
    # fully-replicated output: every process holds the global value
    local = np.asarray(probs)
    if proc_id == 0:
        np.save(out_path, local)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main(
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    )
