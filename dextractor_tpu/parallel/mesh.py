"""Device mesh construction and shardings.

The only parallelism axis in this domain is *reads* — entries are
independent, so the mesh is a 1-D data axis over all cards (the moral
equivalent of the reference's DB block partitioning, DB.h:380-383).
The cards of one host are joined all to all by NVLink, so the axis needs
no topology; across hosts, `jax.distributed` initialization extends the
same mesh.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def data_sharding(mesh: Mesh, rank: int, sharded_dim: int = 0) -> NamedSharding:
    """Shard dimension ``sharded_dim`` of a rank-``rank`` array over data."""
    spec = [None] * rank
    spec[sharded_dim] = DATA_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
