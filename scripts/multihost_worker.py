"""Worker process for multi-host (multi-process) distributed-join runs.

One OS process per host, per SURVEY.md §5's distributed tier.  Launched
N times on localhost with explicit coordinator/process ids, each process
on 4 virtual CPU devices, which exercises exactly the process-boundary
code paths (`parallel/multihost.py`: initialize_multihost, host-major
pod_mesh, process_local_rows) that a real cluster hits first.  The
workers never open an accelerator, so they cannot contend with another
process for a card.

The reference has no distributed tier (single node, hash_join.cpp); this
is the north-star scaling demand.

Usage: multihost_worker.py <port> <process_id> <num_processes>
"""

from __future__ import annotations

import os
import sys

# CPU only, 4 virtual devices per process, set before jax is imported
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")

    from flash_hash_join_tpu.parallel.multihost import (
        initialize_multihost, pod_mesh, process_local_rows)

    port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    initialize_multihost(f"localhost:{port}", nproc, pid)
    me = jax.process_index()

    mesh = pod_mesh()
    flat = list(mesh.devices.flat)
    ndev = len(flat)
    # host-major invariant: process_index is non-decreasing along the axis
    pidx = [d.process_index for d in flat]
    assert pidx == sorted(pidx), f"pod_mesh not host-major: {pidx}"

    # process_local_rows invariants: ranges tile [0, n) disjointly
    for n_global in (1, 7, 1000, 4096):
        spans = []
        total = 0
        for p in range(jax.process_count()):
            # emulate each process's view (pure function of p)
            per = -(-n_global // jax.process_count())
            start = min(p * per, n_global)
            cnt = min(per, n_global - start)
            spans.append((start, cnt))
            total += cnt
        assert total == n_global and spans == sorted(spans)
    start, cnt = process_local_rows(4096)
    assert 0 <= start <= 4096 and 0 <= cnt, (start, cnt)

    # --- the join itself, across the process boundary -------------------
    from flash_hash_join_tpu.parallel.distributed_join import (
        distributed_join_exact)
    from flash_hash_join_tpu.utils import u64
    from flash_hash_join_tpu.utils.config import JoinConfig

    rng = np.random.default_rng(4242)  # identical data on every process
    nb, npr = 2048, 8192
    bk = rng.integers(0, 2**64, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**64, nb, dtype=np.uint64)
    nm = npr // 2
    pk = np.concatenate(
        [rng.choice(bk, nm), rng.integers(0, 2**64, npr - nm, dtype=np.uint64)])
    rng.shuffle(pk)

    kh, kl = u64.split_u64(bk)
    vh, vl = u64.split_u64(bv)
    ph, pl = u64.split_u64(pk)
    cfg = JoinConfig(probe_chunk=1 << 12)
    count = distributed_join_exact(mesh, kh, kl, vh, vl, ph, pl, cfg=cfg)

    oracle = int(np.isin(pk, bk).sum())
    assert count == oracle, (count, oracle)
    print(f"MHOK process={me} ndev={ndev} count={count}", flush=True)


if __name__ == "__main__":
    main()
