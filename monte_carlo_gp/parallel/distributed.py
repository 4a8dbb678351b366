"""Multi-host / multi-process runtime startup (SURVEY.md §5, distributed row).

On a multi-host GPU cluster every host runs the same program;
`initialize_distributed` wires the processes into one global JAX runtime
(`jax.distributed.initialize`) after which `jax.devices()` spans every card
and the existing meshes and shardings (parallel/mesh.py,
parallel/sharded.py) scale out unchanged — XLA inserts the collectives from
the same sharding annotations, as NCCL collectives over NVLink between the
cards of one host and over the network between hosts.

The path is validated without multi-host hardware by an N-process ×
1-CPU-device dryrun (tests/test_multihost.py spawning
tests/multihost_worker.py): gloo-backed CPU collectives, one process per
"host", asserting the sharded Monte Carlo histogram is BITWISE identical to
the single-process run. The reproducibility contract survives process
boundaries because all draws are counter-based (partitionable threefry) —
nothing about the math knows the process layout.
"""

from __future__ import annotations

import os


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    platform: str | None = None,
) -> bool:
    """Join this process into a multi-process JAX runtime.

    Arguments default from the standard environment variables
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID), so
    cluster launchers can export those and call `initialize_distributed()` bare.
    Returns True when distributed mode was initialized, False for
    single-process operation (num_processes absent or 1). Call BEFORE any
    other jax API touches the backend.

    `platform="cpu"` selects gloo collectives for processes that run the
    CPU backend (JAX_PLATFORMS=cpu) — the hardware-free validation
    configuration. On GPU hosts leave it None: the GPU backend uses NCCL.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None

    if not num_processes or num_processes <= 1:
        return False

    if platform == "cpu":
        jax.config.update("jax_cpu_collectives_implementation", "gloo")

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        # Generous barriers: on oversubscribed CI hosts (the 1-core CPU
        # dryrun) processes reach init/shutdown minutes apart while each
        # compiles; the defaults (300 s) have been observed to trip.
        initialization_timeout=600,
        shutdown_timeout_seconds=600,
    )
    return True


def barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Rendezvous every process via the coordination service — WITHOUT
    touching the collectives backend.

    Communicator setup in the collectives layer has its own short
    rendezvous deadline that `initialize_distributed`'s generous timeouts
    do NOT cover: gloo's key-value exchange and TCP pair connect give up
    after ~30 s, and a fresh communicator is created at the first
    EXECUTION of every compiled program that contains a collective. If
    processes reach that first execution more than ~30 s apart — cold or
    per-process compilation caches make minutes of skew routine — the job
    dies with "Gloo context initialization failed: DEADLINE_EXCEEDED" /
    "Connect timeout" even though every process is healthy.

    The fix is to align processes BETWEEN compilation and first execution:
    AOT-compile (`jitted.lower(...).compile()` — no collective runs during
    compilation), call `barrier("compiled")`, then execute; communicator
    creation skew is then milliseconds. This barrier rides the gRPC
    coordination service (long, configurable deadline), so it is safe to
    call while peers are still compiling. No-op in single-process mode.
    """
    from jax._src import distributed as _dist

    client = _dist.global_state.client
    if client is not None:
        client.wait_at_barrier(name, timeout_ms)
