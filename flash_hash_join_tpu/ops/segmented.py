"""Segmented scans over sorted runs — the engine's reduction workhorse.

The replacement for every "per-bucket accumulate" in the reference
(atomic fetch_or into the bloom directory hash_join.cpp:122, per-thread
histogram merges :224-236): rows arrive sorted by segment id (we always sort
for table builds / partitioning anyway), a `jax.lax.associative_scan` with a
segment-aware combiner folds each run, and the last element of each run is
the segment's reduction — all vector ops, no atomics, no scatter conflicts.

u64 arithmetic is exact via (hi, lo) uint32 pairs with carry propagation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def seg_ends(seg_ids: jnp.ndarray) -> jnp.ndarray:
    """Boolean mask of the last element of each run of equal seg_ids."""
    return jnp.concatenate(
        [seg_ids[1:] != seg_ids[:-1], jnp.ones((1,), jnp.bool_)]
    )


def seg_starts(seg_ids: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), seg_ids[1:] != seg_ids[:-1]]
    )


def segmented_scan(combine, values, seg_ids: jnp.ndarray):
    """Inclusive scan of `values` (pytree) with `combine`, restarting at each
    new run of seg_ids.  Returns the scanned pytree.

    Implemented as a Hillis-Steele doubling scan (ceil(log2 n) rounds of
    shift + masked combine) rather than jax.lax.associative_scan: the
    even-odd recursion of associative_scan traces into a deep graph that
    compiles slowly at 1e7+ elements, while this unrolls to ~24 cheap
    fused vector steps.  Work is O(n log n) but each round is one
    elementwise pass streaming through device memory.
    """
    n = seg_ids.shape[0]
    if n == 0:
        return values

    def shift_right(x, d, fill):
        pad = jnp.full((d,) + x.shape[1:], fill, x.dtype)
        return jnp.concatenate([pad, x[:-d]], axis=0)

    d = 1
    while d < n:
        prev_seg = shift_right(seg_ids, d, seg_ids.dtype.type(-1) if
                               jnp.issubdtype(seg_ids.dtype, jnp.signedinteger)
                               else ~seg_ids.dtype.type(0))
        same = prev_seg == seg_ids
        prev_vals = jax.tree_util.tree_map(
            lambda x: shift_right(x, d, x.dtype.type(0)), values
        )
        merged = combine(prev_vals, values)
        values = jax.tree_util.tree_map(
            lambda m, v: jnp.where(same, m, v), merged, values
        )
        d *= 2
    return values


def add_u64(a, b):
    """(hi, lo) + (hi, lo) mod 2**64 with carry."""
    ahi, alo = a
    bhi, blo = b
    lo = alo + blo
    carry = (lo < blo).astype(jnp.uint32)
    return ahi + bhi + carry, lo


def min_u64(a, b):
    ahi, alo = a
    bhi, blo = b
    a_lt = (ahi < bhi) | ((ahi == bhi) & (alo < blo))
    return jnp.where(a_lt, ahi, bhi), jnp.where(a_lt, alo, blo)


def max_u64(a, b):
    ahi, alo = a
    bhi, blo = b
    a_gt = (ahi > bhi) | ((ahi == bhi) & (alo > blo))
    return jnp.where(a_gt, ahi, bhi), jnp.where(a_gt, alo, blo)


def or_u32(a, b):
    return a | b
