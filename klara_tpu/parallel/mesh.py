"""Device-mesh utilities: chain data-parallelism across devices and hosts.

The reference has NO parallel execution of any kind — `run(::Vector{MCJob})`
is a serial map (src/jobs/jobs.jl:212).  This module is the many-chain
replacement (SURVEY.md §2.2): chains are the data-parallel axis, sharded
over a 1-D device mesh; tuner pooling and cross-chain statistics lower to
XLA collectives (psum/pmean) between the devices; multi-host scale-out
uses `jax.distributed.initialize` + the same global mesh.  The mesh is a
plain device list: no interconnect topology is assumed.

With GSPMD, per-step code needs no explicit collectives: `jnp.mean` over
the sharded chains axis inside the jitted job IS the psum.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def chain_mesh(n_devices: Optional[int] = None, axis: str = "chains") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_chains(tree, mesh: Mesh, axis: str = "chains", batch_dim: int = 0):
    """Place every leaf with its ``batch_dim`` sharded over the mesh axis."""

    def put(x):
        x = jax.numpy.asarray(x)
        spec = [None] * x.ndim
        if x.ndim > batch_dim:
            spec[batch_dim] = axis
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    return jax.tree.map(put, tree)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Multi-host entry point: call once per host before building the mesh
    (cross-host all-reduce path).  Thin wrapper over `jax.distributed.initialize`
    so single-host runs can call it unconditionally."""
    if num_processes is None or num_processes <= 1:
        return  # single-host: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
