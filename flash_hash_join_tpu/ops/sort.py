"""Radix-sort and radix-partition primitives over u64 (hi, lo) columns.

The reference's parallel radix partitioner (hash_join.cpp:209-292: per-thread
histograms -> prefix sums -> scatter) is a shared-memory construction; the
equivalent here is sort-by-partition-id + segment offsets, which XLA
lowers to its native multi-pass device sort.  The partition offsets play the
role of the reference's prefix-summed histogram and double as the shuffle
plan for the distributed tier (SURVEY.md §2 C5/C6 mapping).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from flash_hash_join_tpu.ops.hashing import hash_u64


def sort_u64(kh: jnp.ndarray, kl: jnp.ndarray, *payloads: jnp.ndarray):
    """Sort rows ascending by u64 key; payload columns move with the keys."""
    ops = jax.lax.sort((kh.astype(jnp.uint32), kl.astype(jnp.uint32))
                       + tuple(payloads), num_keys=2, is_stable=True)
    return ops


class PartitionResult(NamedTuple):
    pid: jnp.ndarray       # (n,) uint32 partition id per (sorted) row
    offsets: jnp.ndarray   # (P+1,) int32 exclusive partition offsets
    cols: tuple            # sorted columns, partition-contiguous


def radix_partition_by_hash(
    cols: tuple[jnp.ndarray, ...],
    kh: jnp.ndarray,
    kl: jnp.ndarray,
    *,
    pbits: int,
    pre_shift: int = 0,
) -> PartitionResult:
    """Partition rows by the top pbits of their key hash (after pre_shift).

    Partition id nests with the distributed destination id and the table's
    home group — all are bit-slices of ONE hash (ops/hashing.py), so
    device -> partition -> bucket refine each other, mirroring how the
    reference reuses hash>>56 for both radix partition and tag.
    """
    h = hash_u64(kh.astype(jnp.uint32), kl.astype(jnp.uint32))
    h = h << jnp.uint32(pre_shift)
    pid = h >> jnp.uint32(32 - pbits)

    sorted_ops = jax.lax.sort((pid,) + tuple(cols), num_keys=1, is_stable=False)
    pid_s, cols_s = sorted_ops[0], sorted_ops[1:]

    nparts = 1 << pbits
    counts = jax.ops.segment_sum(
        jnp.ones(pid.shape, jnp.int32), pid_s.astype(jnp.int32),
        num_segments=nparts,
    )
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)]
    )
    return PartitionResult(pid=pid_s, offsets=offsets, cols=tuple(cols_s))
