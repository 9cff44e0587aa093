"""Device-mesh helpers and multi-host initialization.

The reference has **no** parallelism or communication backend of any
kind (SURVEY.md §2: no MPI/NCCL/threads anywhere) — this subsystem is
net-new, mandated by BASELINE.json's north star: operators row/block-
partitioned over a device mesh, collectives over the interconnect via
``shard_map``/``pjit``, multi-host process groups via
``jax.distributed``.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "row_sharding", "replicated_sharding", "initialize_multihost"]

#: canonical mesh-axis name for the row partition of operators/vectors
ROWS = "rows"


def make_mesh(n_devices: int | None = None, axis_name: str = ROWS, devices=None) -> Mesh:
    """A 1-D mesh over ``n_devices`` (default: all local devices).

    The row axis is the SpMV analog of data/tensor parallelism: operator
    block rows, vector segments, and the Krylov basis columns all shard
    over it (SURVEY.md §5).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def row_sharding(mesh: Mesh, axis_name: str = ROWS, ndim: int = 1, axis: int = 0):
    """NamedSharding that shards array axis ``axis`` over the mesh rows."""
    spec = [None] * ndim
    spec[axis] = axis_name
    return NamedSharding(mesh, PartitionSpec(*spec))


def replicated_sharding(mesh: Mesh):
    return NamedSharding(mesh, PartitionSpec())


def initialize_multihost(
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    *,
    make_global_mesh: bool = False,
    axis_name: str = ROWS,
):
    """Initialize the multi-host process group (DCN across hosts, ICI
    within a slice) — wrapper over ``jax.distributed.initialize`` so
    single-host use needs no call at all.

    Validation added round 3 (the wrapper is untestable end-to-end on a
    1-host box, so argument-contract errors must surface HERE, not as a
    coordinator-timeout hang minutes later on a pod): the three
    arguments must be given together or not at all (all-None = the
    environment's own auto-detection), ``process_id`` must lie in
    ``[0, num_processes)``, and a repeated call is rejected with a clear
    message instead of jax's RuntimeError.

    ``make_global_mesh=True`` additionally returns a 1-D mesh over ALL
    processes' devices (``jax.devices()`` is global after
    initialization) — the usual next line of every multi-host script.
    """
    given = [coordinator_address is not None, num_processes is not None,
             process_id is not None]
    if any(given) and not all(given):
        raise ValueError(
            "initialize_multihost needs coordinator_address, num_processes "
            "AND process_id together (or none of them, for the environment's "
            "own auto-detection)"
        )
    if num_processes is not None:
        num_processes = int(num_processes)
        process_id = int(process_id)
        if num_processes <= 0:
            raise ValueError(f"num_processes must be positive, got {num_processes}")
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id {process_id} outside [0, {num_processes})"
            )
    if jax.distributed.is_initialized():
        raise RuntimeError(
            "jax.distributed is already initialized in this process — "
            "initialize_multihost must be called exactly once, before any "
            "jax device use"
        )
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
        kw["num_processes"] = num_processes
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)
    if make_global_mesh:
        return make_mesh(axis_name=axis_name)
    return None
