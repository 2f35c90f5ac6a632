"""Multi-host (multi-process) execution scaffolding.

The reference's only "distribution" is a 2-thread browser split
(SURVEY.md §5.8); BASELINE.json demands frames/s scaling measured at
1 chip / 1 host / N≥2 hosts. This module provides the process-level
entry points:

- :func:`initialize_multihost` — ``jax.distributed.initialize`` wrapper
  (coordinator rendezvous; the coordinator address, process count and
  process id are passed explicitly).
- :func:`global_mesh` — a 1-D mesh over ALL global devices. The cards of
  one host are joined all to all, so the landmark-Schur ``psum``
  (parallel/distributed.py) needs no mesh shape beyond the algorithm's
  1-D landmark axis; JAX's device order keeps each host's cards
  contiguous, so across hosts shard landmarks within a host and
  keyframes/windows across hosts.
- :func:`put_global` — build a global ``jax.Array`` from a
  process-local full copy (every process holds the same host data, the
  standard SPMD pattern for replicated problem inputs).

Tested with the standard JAX fake-cluster trick (SURVEY.md §4): N
processes on one machine, CPU backend with gloo collectives
(tests/test_multihost.py spawns 2 processes × 4 virtual devices and
checks the landmark-sharded BA against the single-process result).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join (or form) a multi-process JAX cluster.

    Pass all three: nothing in a plain GPU or CPU cluster tells JAX its
    coordinator. Safe to call once per process,
    before any other JAX API touches a backend.
    """
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif num_processes is not None or process_id is not None:
        # Silently dropping these would let the process initialize as a
        # standalone single-process "cluster" and compute on a fraction
        # of the data with no rendezvous.
        raise ValueError(
            "num_processes/process_id were given without "
            "coordinator_address — the fake-cluster mode needs all three"
        )
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "shard") -> Mesh:
    """1-D mesh over all global devices (every process's devices)."""
    return Mesh(np.asarray(jax.devices()), axis_names=(axis,))


def put_global(x, mesh: Mesh, spec: P):
    """Global array from a process-local full copy of ``x``.

    Every process must hold identical host data (the replicated-input
    SPMD pattern); each contributes the shards its devices own.
    """
    x = np.asarray(x)
    sharding = NamedSharding(mesh, spec)
    # Return the numpy slice directly: wrapping it in jnp.asarray
    # committed every shard to the default device first, so each shard
    # took a default-device hop before landing on its owner.
    return jax.make_array_from_callback(
        x.shape, sharding, lambda idx: x[idx]
    )


def replicate_global(x, mesh: Mesh):
    """Fully-replicated global array from a process-local copy."""
    return put_global(x, mesh, P())
