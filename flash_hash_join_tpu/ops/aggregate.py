"""Hash aggregate (group-by) over u64 keys — north-star primitive
(BASELINE.json: "hash-aggregate/filter/radix-sort primitives [joins]
decompose into").  NOT PRESENT as a public op in the reference; its hash
table IS the degenerate first-value aggregate.

Design: same spine as the join build (ops/hash_table.py) —
hash -> sort rows by (home, key) -> segment boundaries — then exact u64
segmented reductions (ops/segmented.py) instead of slot placement.  Output
is padded to the input length (static shapes); `n_groups` rows are valid,
emitted in (home, key) sort order (deterministic).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from flash_hash_join_tpu.ops.hashing import hash_u64
from flash_hash_join_tpu.ops import segmented as seg


class GroupByResult(NamedTuple):
    n_groups: jnp.ndarray   # () int32
    key_hi: jnp.ndarray     # (n,) uint32, first n_groups valid
    key_lo: jnp.ndarray
    count: jnp.ndarray      # (n,) int32 per-group row count
    sum_hi: jnp.ndarray     # exact u64 sum (mod 2**64)
    sum_lo: jnp.ndarray
    min_hi: jnp.ndarray
    min_lo: jnp.ndarray
    max_hi: jnp.ndarray
    max_lo: jnp.ndarray


def hash_aggregate(
    kh: jnp.ndarray,
    kl: jnp.ndarray,
    vh: jnp.ndarray,
    vl: jnp.ndarray,
    n_valid: jnp.ndarray | int,
    *,
    gbits: int = 20,
) -> GroupByResult:
    """Group rows by u64 key; compute count / sum / min / max of values.

    Invalid rows (index >= n_valid) are excluded.  All reductions are exact:
    sums are modular u64 with carry propagation, min/max lexicographic on
    (hi, lo).
    """
    n = kh.shape[0]
    n_valid = jnp.asarray(n_valid, jnp.int32)
    valid = jnp.arange(n, dtype=jnp.int32) < n_valid

    kh = kh.astype(jnp.uint32)
    kl = kl.astype(jnp.uint32)
    vh = vh.astype(jnp.uint32)
    vl = vl.astype(jnp.uint32)

    h = hash_u64(kh, kl)
    home = jnp.where(valid, h >> jnp.uint32(32 - gbits), jnp.uint32(0xFFFFFFFF))

    home_s, kh_s, kl_s, vh_s, vl_s, valid_s = jax.lax.sort(
        (home, kh, kl, vh, vl, valid.astype(jnp.uint32)),
        num_keys=3, is_stable=False,
    )
    valid_s = valid_s.astype(jnp.bool_)

    # Segment id = run of equal keys.  Invalid rows keep their raw key but
    # carry home 0xFFFFFFFF (> any valid home of gbits <= 32), so including
    # home in the boundary test guarantees the invalid tail starts its own
    # segment even when its first key equals the last valid group's key.
    new_key = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         (home_s[1:] != home_s[:-1])
         | (kh_s[1:] != kh_s[:-1]) | (kl_s[1:] != kl_s[:-1])]
    )
    seg_id = jnp.cumsum(new_key.astype(jnp.int32)) - 1

    sums = seg.segmented_scan(seg.add_u64, (vh_s, vl_s), seg_id)
    mins = seg.segmented_scan(seg.min_u64, (vh_s, vl_s), seg_id)
    maxs = seg.segmented_scan(seg.max_u64, (vh_s, vl_s), seg_id)
    cnts = seg.segmented_scan(lambda a, b: a + b,
                              jnp.ones((n,), jnp.int32), seg_id)

    is_end = seg.seg_ends(seg_id)
    emit = is_end & valid_s
    n_groups = jnp.sum(emit).astype(jnp.int32)

    pos = jnp.cumsum(emit.astype(jnp.int32)) - 1
    idx = jnp.where(emit, pos, n + jnp.arange(n, dtype=jnp.int32))

    def compact(x, init):
        out = jnp.full((n,), init, x.dtype)
        return out.at[idx].set(x, mode="drop", unique_indices=True)

    return GroupByResult(
        n_groups=n_groups,
        key_hi=compact(kh_s, jnp.uint32(0)),
        key_lo=compact(kl_s, jnp.uint32(0)),
        count=compact(cnts, jnp.int32(0)),
        sum_hi=compact(sums[0], jnp.uint32(0)),
        sum_lo=compact(sums[1], jnp.uint32(0)),
        min_hi=compact(mins[0], jnp.uint32(0)),
        min_lo=compact(mins[1], jnp.uint32(0)),
        max_hi=compact(maxs[0], jnp.uint32(0)),
        max_lo=compact(maxs[1], jnp.uint32(0)),
    )
