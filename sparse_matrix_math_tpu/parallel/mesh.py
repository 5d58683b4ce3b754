"""Device-mesh helpers for the 1-D row-partition distribution.

The reference's only parallelism is TBB shared-memory threading over
matrix rows (reference include/sparse_matrix_math.h:1493-1497); the
The scaling axis is the same row dimension, laid out over a 1-D
``jax.sharding.Mesh`` (SURVEY §2.3).  All collectives (psum for dots,
all_gather for the multiplicand halo) ride ICI along this axis — and,
once :func:`init_distributed` has joined multiple processes, DCN across
hosts: ``jax.devices()`` then returns the GLOBAL device list, so the
same 1-D mesh spans the whole job and XLA routes the collectives over
the right fabric per hop.

Multi-host data movement rules (used by ``distribute_*``/``collect``):

* placement goes through :func:`put_sharded` — ``jax.device_put`` when
  one process owns every device, ``jax.make_array_from_callback`` (each
  process materialises only ITS shards) when the mesh spans processes;
* gathering goes through :func:`gather_to_host` —
  ``multihost_utils.process_allgather`` across processes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np

__all__ = [
    "ROW_AXIS",
    "make_mesh",
    "mesh_of",
    "resolve_mesh",
    "row_sharding",
    "replicated_sharding",
    "init_distributed",
    "put_sharded",
    "gather_to_host",
]

ROW_AXIS = "rows"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    simulate_cpu_devices: Optional[int] = None,
) -> None:
    """Join this process into a multi-host JAX job (SURVEY §2.3 DCN row).

    Call once per process before any other JAX use.  With no arguments
    jax.distributed.initialize picks everything up from the cluster
    environment (managed clusters auto-detect; otherwise the standard
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env
    vars).  After it returns, ``jax.devices()`` is the GLOBAL device
    list and :func:`make_mesh` builds process-spanning meshes.

    ``simulate_cpu_devices=k`` pins the CPU backend with ``k`` local
    virtual devices and gloo cross-process collectives — a laptop/CI
    simulation of an N-host job (tests/test_multiprocess.py drives a
    2-process x 4-device solve through exactly this path).
    """
    if simulate_cpu_devices is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", int(simulate_cpu_devices))
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = int(num_processes)
    if process_id is not None:
        kw["process_id"] = int(process_id)
    jax.distributed.initialize(**kw)


def put_sharded(host_array, mesh: jax.sharding.Mesh, spec) -> jax.Array:
    """Place a host array onto ``mesh`` with PartitionSpec ``spec``.

    Single-process: plain ``jax.device_put``.  Process-spanning mesh:
    ``jax.make_array_from_callback`` so each process touches only the
    shards it can address (``host_array`` must be the same full global
    array on every process — the standard replicated-ingest pattern; use
    per-host loaders upstream if the data doesn't fit one host).
    """
    sharding = jax.sharding.NamedSharding(mesh, spec)
    arr = np.asarray(host_array)
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx]
    )


def gather_to_host(x: jax.Array) -> np.ndarray:
    """Fetch a (possibly process-spanning) sharded array as a full host
    ndarray, on every process."""
    if jax.process_count() == 1:
        return np.asarray(jax.device_get(x))
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    axis: str = ROW_AXIS,
    devices: Optional[Sequence] = None,
) -> jax.sharding.Mesh:
    """A 1-D mesh over ``n_devices`` (default: all available devices)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"requested {n_devices} devices, only {len(devices)} available"
                )
            devices = devices[:n_devices]
    return jax.sharding.Mesh(np.asarray(devices), (axis,))


def mesh_of(*arrays) -> Optional[jax.sharding.Mesh]:
    """The concrete Mesh an already-placed array lives on, or None.

    Solve-time entry points default to the mesh their distributed
    operand was BUILT on: a process whose default device list differs
    from the build mesh (e.g. an accelerator plugin registered alongside
    the virtual-CPU mesh — ``jax.devices()`` then returns the 1-chip
    accelerator list) must not silently ``shard_map`` an 8-shard operand
    over a 1-device axis; the mismatch used to surface as a cryptic
    broadcast error deep inside the local SpMV.
    """
    for x in arrays:
        mesh = getattr(getattr(x, "sharding", None), "mesh", None)
        if isinstance(mesh, jax.sharding.Mesh):
            return mesh
    return None


def resolve_mesh(
    mesh: Optional[jax.sharding.Mesh],
    *arrays,
    n_shards: Optional[int] = None,
    axis: str = ROW_AXIS,
) -> jax.sharding.Mesh:
    """An explicit ``mesh``, else the operand arrays' mesh (:func:`mesh_of`),
    else :func:`make_mesh` — validated against the operand's shard count."""
    if mesh is None:
        mesh = mesh_of(*arrays)
        if mesh is None:
            mesh = make_mesh()
    if n_shards is not None and mesh.shape[axis] != n_shards:
        raise ValueError(
            f"mesh has {mesh.shape[axis]} devices on axis {axis!r} but the "
            f"distributed operand was built for {n_shards} shards; pass the "
            "mesh it was distributed over"
        )
    return mesh


def row_sharding(mesh: jax.sharding.Mesh, *, axis: str = ROW_AXIS):
    """NamedSharding that splits an array's leading dim across the mesh."""
    return jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(axis))


def replicated_sharding(mesh: jax.sharding.Mesh):
    return jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
