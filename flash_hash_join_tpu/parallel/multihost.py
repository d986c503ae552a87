"""Multi-host initialization + pod-slice mesh construction.

NOT PRESENT in the reference (single node).  The north star
(BASELINE.json) demands a tier that scales 1 device -> 1 host -> >= 2
hosts: `jax.distributed.initialize` (one process per host, every device
of the cluster visible as a global device) plus a mesh whose axis order
keeps the join's all_to_all between devices of one host (NVLink) apart
from the slices that cross hosts.

The same `build_distributed_join` graph compiles over any 1-D mesh: one
host's 4 GPUs (chip_smoke.py --four-cards), 8 virtual CPU devices (the
test suite), or 2 processes x 4 virtual devices (tests/test_multihost.py,
through this module).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int) -> None:
    """Initialize jax.distributed for a multi-host cluster.

    Nothing is discovered from the environment: every process names the
    coordinator (host:port), the process count and its own id.  Call once
    per process, before any jax computation.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def pod_mesh(axis_name: str = "x") -> Mesh:
    """1-D mesh over ALL global devices of the cluster, ordered host-major.

    Host-major order keeps the hash shuffle's all_to_all between
    same-host destinations inside a host; only the inter-host slices of
    the exchange cross the network.  The join's device id is a hash
    bit-slice (parallel/shuffle.py), so the device count must be a power
    of two.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n = len(devs)
    if n & (n - 1):
        raise ValueError(f"pod size must be a power of two, got {n}")
    return Mesh(np.asarray(devs), (axis_name,))


def process_local_rows(n_global: int) -> tuple[int, int]:
    """(start, count) of this host's row range for building sharded inputs
    with jax.make_array_from_process_local_data-style feeding."""
    p = jax.process_index()
    np_ = jax.process_count()
    per = -(-n_global // np_)
    start = min(p * per, n_global)
    return start, min(per, n_global - start)
