"""Device-mesh utilities.

The reference is strictly single-device (SURVEY §2.3: no distributed backend
anywhere); scaling across several GPUs and hosts is a new capability of
this framework.  Two axes of parallelism:

- ``batch``: independent problem instances sharded across devices (the
  batched version of the reference's serial benchmark sweeps,
  scripts/benchmarks_cpu.jl:15-58) — needs no communication, so it may
  cross hosts over the network.
- ``cols``: the variable dimension of one large instance sharded across
  devices for Schur-complement KKT assembly (parallel/schur.py) — its
  collectives run every iteration, so it stays within a host, where the
  GPUs are joined all to all by NVLink.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("batch",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a 1D (or reshaped) mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))


def batch_sharding(mesh: Mesh, axis: str = "batch") -> NamedSharding:
    """Sharding that splits the leading (stacked-instance) dimension."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join the multi-host JAX runtime (no-op when single-process).

    Thin wrapper over ``jax.distributed.initialize``.  Pass the
    coordinator's ``host:port``, the process count and this process's index
    (or set ``JAX_COORDINATOR_ADDRESS`` and let a cluster environment that
    JAX recognizes supply the rest).  Returns the local process index.  XLA
    owns all transport (NCCL over NVLink within a host, the network across
    hosts) — there is no hand-written communication code in this
    framework.
    """
    # Do not touch the backend before deciding: jax.distributed.initialize
    # must run before any computation, and is a no-op need when neither the
    # caller nor the environment configures a coordinator.
    if coordinator_address or num_processes or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        except RuntimeError:
            pass  # already initialized
    return jax.process_index()


def make_multihost_mesh(
    axis_names: Sequence[str] = ("batch", "cols"),
    cols: int = 1,
) -> Mesh:
    """Global mesh over every device of every process.

    Layout: ``batch`` (outer, crosses hosts — data parallel over the
    network) x ``cols`` (inner, within one host's NVLink domain — Schur
    model parallel).  ``cols`` must divide the per-host device count so the
    column all-reduce never leaves the host.
    """
    devs = jax.devices()
    per_host = len([d for d in devs if d.process_index == 0]) or len(devs)
    if per_host % cols != 0:
        raise ValueError(
            f"cols={cols} must divide the per-host device count {per_host} "
            "(the Schur psum must stay within one host)"
        )
    arr = np.asarray(devs).reshape(len(devs) // cols, cols)
    return Mesh(arr, axis_names=tuple(axis_names))
