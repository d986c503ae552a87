"""Ragged hash shuffle over a device mesh axis.

The distributed generalization of the reference's radix partitioner
(parallel_radix_partition_kv/_k, hash_join.cpp:209-292): partition id = top
bits of the SAME hash used for table bucketing, but here the partition id
selects the destination DEVICE and the exchange rides the interconnect via
`jax.lax.all_to_all` instead of a shared-memory scatter.

XLA collectives need static shapes, so the ragged exchange uses fixed-quota
buckets: each device sorts its rows by destination, packs them into ONE
(ndev, ncols+1, quota) send tensor — all columns plus the per-bucket counts
ride a single all_to_all (round 1 issued one collective per column; fusing
them lets the interconnect see one large transfer and leaves XLA's latency-hiding
scheduler one op to overlap with compute).  Rows beyond the quota are
dropped and COUNTED (returned as `overflow`, psum'd) — callers size the
quota with a safety factor, handle skew with heavy-hitter replication
(parallel/distributed_join.py), and treat overflow > 0 as a retry signal
(distributed_join_exact regrows the quota).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from flash_hash_join_tpu.ops.hashing import hash_u64


def dest_device(kh, kl, dbits: int) -> jnp.ndarray:
    """Destination device id = top dbits of the key hash (0 if dbits == 0)."""
    if dbits == 0:
        return jnp.zeros(kh.shape, jnp.uint32)
    h = hash_u64(kh, kl)
    return h >> jnp.uint32(32 - dbits)


def hash_shuffle(
    cols: tuple[jnp.ndarray, ...],
    dest: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    ndev: int,
    quota: int,
    axis_name: str,
):
    """Exchange rows so device d receives every row with dest == d.

    cols: equal-length uint32 row columns on this shard.
    dest: (n,) uint32 destination device per row.
    valid: (n,) bool; invalid rows are not sent.

    Returns (recv_cols, recv_valid, overflow):
      recv_cols: tuple of (ndev * quota,) uint32 arrays (padded),
      recv_valid: (ndev * quota,) bool mask of real rows,
      overflow: () int32, GLOBAL count of rows dropped for quota overflow.
    """
    n = dest.shape[0]
    ncols = len(cols)
    dest = jnp.where(valid, dest.astype(jnp.uint32), jnp.uint32(ndev))

    # Sort rows by destination; invalid rows (dest=ndev) sink to the end.
    sort_ops = jax.lax.sort((dest,) + tuple(c.astype(jnp.uint32) for c in cols),
                            num_keys=1, is_stable=False)
    dest_s, cols_s = sort_ops[0], sort_ops[1:]

    counts = jax.ops.segment_sum(
        jnp.ones((n,), jnp.int32), dest_s.astype(jnp.int32),
        num_segments=ndev + 1
    )[:ndev]
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]]
    )
    dest_i = dest_s.astype(jnp.int32)
    safe_dest = jnp.minimum(dest_i, ndev - 1)
    rank = jnp.arange(n, dtype=jnp.int32) - starts[safe_dest]

    sendable = (dest_i < ndev) & (rank < quota)
    overflow_local = jnp.sum((dest_i < ndev) & (rank >= quota)).astype(jnp.int32)

    flat = safe_dest * quota + rank
    flat = jnp.where(sendable, flat, ndev * quota + jnp.arange(n, dtype=jnp.int32))

    send_counts = jnp.minimum(counts, quota)

    # ONE stacked collective: columns plus the counts row.
    send = jnp.zeros((ncols + 1, ndev * quota), jnp.uint32)
    for i, c in enumerate(cols_s):
        send = send.at[i].set(
            jnp.zeros((ndev * quota,), jnp.uint32)
            .at[flat].set(c, mode="drop", unique_indices=True))
    cnt_plane = jnp.zeros((ndev, quota), jnp.uint32)
    cnt_plane = cnt_plane.at[:, 0].set(send_counts.astype(jnp.uint32))
    send = send.at[ncols].set(cnt_plane.reshape(-1))

    recv = jax.lax.all_to_all(
        send.reshape(ncols + 1, ndev, quota), axis_name,
        split_axis=1, concat_axis=1, tiled=False,
    )
    recv_cols = tuple(recv[i].reshape(ndev * quota) for i in range(ncols))
    recv_counts = recv[ncols].reshape(ndev, quota)[:, 0].astype(jnp.int32)
    lane = jnp.arange(quota, dtype=jnp.int32)
    recv_valid = (lane[None, :] < recv_counts[:, None]).reshape(ndev * quota)

    overflow = jax.lax.psum(overflow_local, axis_name)
    return recv_cols, recv_valid, overflow
