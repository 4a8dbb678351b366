"""Device-mesh construction and single-race sharded Monte Carlo.

Scaling model ("How to Scale Your Model" recipe): pick a mesh, annotate the
batch axis sharding, let XLA insert collectives. The simulation batch is
embarrassingly parallel — GSPMD partitions every (n_sims, D) array over the
'sims' axis; the single collective is the psum of the (D, D) histogram.
Counter-based partitionable threefry makes the result bitwise identical to
the single-device run (tests/test_determinism.py, tests/test_sharding.py).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from monte_carlo_gp.config import SimParams
from monte_carlo_gp.ops.engine import simulate_races


def make_mesh(
    axis_sizes: dict[str, int] | None = None, devices=None
) -> Mesh:
    """Build a mesh from {axis_name: size}. Default: all devices on 'sims'.

    Put 'sims' innermost so histogram reductions stay within the cards of
    one host (NVLink); a leading 'race' axis batches independent races.
    """
    devices = devices if devices is not None else jax.devices()
    if axis_sizes is None:
        axis_sizes = {"sims": len(devices)}
    names = tuple(axis_sizes.keys())
    sizes = tuple(axis_sizes.values())
    if math.prod(sizes) > len(devices):
        raise ValueError(
            f"mesh {axis_sizes} needs {math.prod(sizes)} devices, "
            f"have {len(devices)}"
        )
    grid = np.array(devices[: math.prod(sizes)]).reshape(sizes)
    return Mesh(grid, names)


@functools.partial(
    jax.jit, static_argnames=("n_sims", "total_laps", "mesh", "sims_axis")
)
def _sharded_probs(
    params: SimParams,
    key: jax.Array,
    n_sims: int,
    total_laps: int,
    mesh: Mesh,
    sims_axis: str,
) -> jax.Array:
    positions = simulate_races(params, key, n_sims, total_laps)
    positions = jax.lax.with_sharding_constraint(
        positions, NamedSharding(mesh, P(sims_axis, None))
    )
    d = params.n_drivers
    onehot = positions[..., None] == jnp.arange(1, d + 1, dtype=positions.dtype)
    counts = jnp.sum(onehot, axis=0, dtype=jnp.int32)  # GSPMD -> psum over sims
    return counts.astype(jnp.float32) / n_sims


def sharded_monte_carlo(
    params: SimParams,
    key: jax.Array,
    n_sims: int,
    total_laps: int,
    mesh: Mesh | None = None,
    sims_axis: str = "sims",
) -> jax.Array:
    """`run_monte_carlo` with the simulation batch sharded over `mesh`.

    Returns replicated (D, D) probabilities, bitwise identical to the
    unsharded run with the same key.
    """
    mesh = mesh or make_mesh()
    if n_sims % mesh.shape[sims_axis] != 0:
        raise ValueError(
            f"n_sims={n_sims} must divide evenly over the '{sims_axis}' axis "
            f"({mesh.shape[sims_axis]} devices)"
        )
    with jax.set_mesh(mesh):
        return _sharded_probs(params, key, n_sims, total_laps, mesh, sims_axis)
