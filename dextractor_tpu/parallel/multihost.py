"""Multi-host runtime: jax.distributed initialization + ordered gather.

The device-parallel replacement for the reference's HPC job-array fan-out
(Block_Looper, DB.c:2657-2923): one mesh spanning all hosts, with the data
axis over the cards of a host (NVLink) and across hosts (SURVEY §5).
"""

from __future__ import annotations

import os

import numpy as np


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize with env-var defaults; no-op when single
    process (the common single-host case and all tests)."""
    import jax

    num = num_processes if num_processes is not None else int(
        os.environ.get("DXT_NUM_PROCESSES", "1"))
    if num <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator or os.environ.get("DXT_COORDINATOR"),
        num_processes=num,
        process_id=process_id if process_id is not None else int(
            os.environ.get("DXT_PROCESS_ID", "0")))


def mesh_put(mesh):
    """An uploader closure for ``mesh``: host numpy -> device array with a
    given PartitionSpec.

    Single-process meshes take the plain jnp path; a mesh spanning
    processes builds a global distributed array from each process's host
    copy (every process must hold the full host array — true for the
    control-plane metadata this is used on; bulk data is fed per-host).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    multi = any(d.process_index != jax.process_index()
                for d in mesh.devices.flat)

    def put(arr, spec):
        if not multi:
            return jnp.asarray(arr)
        arr = np.asarray(arr)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(arr.shape, sh,
                                            lambda idx: arr[idx])
    return put


def ordered_gather(parts: list[tuple[np.ndarray, np.ndarray]]):
    """Gather variable-length per-read results back into original read
    order.

    Shards hold contiguous read blocks in order, so the gather is a
    concatenation of (flat payload, per-read lengths) pairs — the moral
    equivalent of the reference's sequential fwrite order (dexta.c:196-204)
    with prefix-sum offsets available for random access.
    Returns (flat, lengths, offsets).
    """
    flat = np.concatenate([p for p, _ in parts]) if parts else np.empty(0, np.uint8)
    lengths = np.concatenate([l for _, l in parts]) if parts else np.empty(0, np.int64)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return flat, lengths, offsets


def process_read_range(total_reads: int, process_id: int | None = None,
                       num_processes: int | None = None):
    """The contiguous read block owned by this host (block partitioning,
    the moral equivalent of DB.h:380-383 ublocks)."""
    import jax

    pid = process_id if process_id is not None else jax.process_index()
    num = num_processes if num_processes is not None else jax.process_count()
    per = (total_reads + num - 1) // num
    beg = min(pid * per, total_reads)
    end = min(beg + per, total_reads)
    return beg, end
