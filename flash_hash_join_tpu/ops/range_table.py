"""Range table: the partitioned ("radix") tier.

Reference regime being replaced: the radix join (hash_join.cpp:209-292
partitioners + :316-381/:498-534 per-partition tables).  The reference
radix-partitions both sides so each sub-join fits in cache; here one sort
of the build side does the same job and its sorted key planes ARE the
table:

  * build = ONE lax.sort of (key words, build row) with the values riding
    along as payload;
  * probe = a branchless binary search (lower bound) per probe row over the
    sorted key planes, then one compare and (materialize) one value gather
    at the position found.  On a CUDA device the search runs as one fused
    Pallas Triton kernel (ops/pallas/range_probe.py), elsewhere as plain
    jnp (`search`); both give identical results.  Probes stay in input
    order and are never sorted.  No window, no buckets: every probe
    resolves exactly, so the unresolved counter special[3] is always 0.

Key widths:
  wide   — 64-bit keys as (key_hi, key_lo) u32 planes, compared
           lexicographically.
  narrow — 32-bit keys (key_hi all zero, checked by the caller): the table
           and the search use the lo word alone, half the gathers.

Semantics contract (SURVEY.md §3): inner first-match join.  Duplicate
build keys sort by build row, so the lower bound lands on the FIRST input
occurrence — the same winner as the global, merge and direct tiers and
the C++ oracle.  The maximum key (u64 max, or u32 max in narrow mode) is
the sort sentinel of invalid rows, so it rides the `special` side channel
exactly like ops/hash_table.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

EMPTY32 = np.uint32(0xFFFFFFFF)  # numpy: importing this module must not init the XLA backend


class RangeTable(NamedTuple):
    """Sorted build side (device arrays).

    keys: sorted key planes, (kh, kl) wide or (kl,) narrow, each (n,);
    invalid and maximum-key rows hold the all-ones sentinel and sort last.
    values: sorted value planes, (vh, vl) or (vl,) under narrow values, or
    None for count.  special: (4,) uint32 [has_max_key, max_val_hi,
    max_val_lo, unresolved (always 0)].
    """

    keys: tuple
    values: tuple | None
    special: jnp.ndarray


def build_range_table(kh, kl, vh, vl, n_valid, *, narrow: bool = False,
                      with_values: bool = True,
                      narrow_values: bool = False) -> RangeTable:
    """Sort build rows by (key words, row) into the range table."""
    n = kh.shape[0]
    row_valid = jnp.arange(n, dtype=jnp.int32) < jnp.asarray(n_valid,
                                                               jnp.int32)
    kh = jnp.where(row_valid, kh.astype(jnp.uint32), EMPTY32)
    kl = jnp.where(row_valid, kl.astype(jnp.uint32), EMPTY32)
    vh = vh.astype(jnp.uint32)
    vl = vl.astype(jnp.uint32)

    is_max = (kl == EMPTY32) if narrow else (kh == EMPTY32) & (kl == EMPTY32)
    is_max = is_max & row_valid
    has_max = jnp.any(is_max)
    first_max = jnp.argmax(is_max)
    max_vh = jnp.where(has_max, vh[first_max], jnp.uint32(0))
    max_vl = jnp.where(has_max, vl[first_max], jnp.uint32(0))

    key_cols = (kl,) if narrow else (kh, kl)
    payload = ()
    if with_values:
        # narrow_values: value_hi is identically zero (caller-checked)
        payload = (vl,) if narrow_values else (vh, vl)
    rows = jnp.arange(n, dtype=jnp.int32)
    # the row index as the last sort key makes the order total, so the
    # sort is deterministic and equal keys keep input order
    out = jax.lax.sort(key_cols + (rows,) + payload,
                       num_keys=len(key_cols) + 1, is_stable=False)
    nk = len(key_cols)
    special = jnp.stack([has_max.astype(jnp.uint32), max_vh, max_vl,
                         jnp.uint32(0)])
    return RangeTable(tuple(out[:nk]),
                      tuple(out[nk + 1:]) if with_values else None, special)


def _lex_lt(a_words, b_words):
    """a < b, lexicographic over uint32 word tuples."""
    lt = a_words[-1] < b_words[-1]
    for a, b in zip(a_words[-2::-1], b_words[-2::-1]):
        lt = (a < b) | ((a == b) & lt)
    return lt


def search(table_keys, probe_keys):
    """Position of each probe's key in the sorted table, or -1 if absent.

    A branchless lower bound: the power-of-two steps are unrolled, so the
    whole search is one chain of gathers that XLA can fuse.  Returns the
    first table row equal to the probe (int32), -1 when there is none.
    """
    n = table_keys[0].shape[0]
    if n == 0:
        return jnp.full(probe_keys[0].shape, -1, jnp.int32)
    pos = jnp.zeros(probe_keys[0].shape, jnp.int32)
    step = 1 << (n.bit_length() - 1)
    while step:
        cand = pos + step
        idx = jnp.minimum(cand, n) - 1
        below = _lex_lt(tuple(w[idx] for w in table_keys), probe_keys)
        pos = jnp.where(below & (cand <= n), cand, pos)
        step >>= 1
    idx = jnp.minimum(pos, n - 1)
    eq = pos < n
    for w, p in zip(table_keys, probe_keys):
        eq = eq & (w[idx] == p)
    return jnp.where(eq, idx, -1)


def _device_search(table_keys, probe_keys):
    """The search the join graphs run: the fused Pallas Triton kernel
    (ops/pallas/range_probe.py) when lowered for a CUDA device, the plain
    `search` everywhere else.  Both return identical positions; the kernel
    measured faster on an H100 at the 1e8-row shape (PERF.md)."""
    from flash_hash_join_tpu.ops.pallas import range_probe as rp
    return jax.lax.platform_dependent(table_keys, probe_keys,
                                      cuda=rp.search, default=search)


def _probe(table: RangeTable, ph, pl, np_valid, narrow: bool):
    """(found row or -1, valid non-max probe mask, valid max-key mask)."""
    n = ph.shape[0]
    valid = jnp.arange(n, dtype=jnp.int32) < jnp.asarray(np_valid, jnp.int32)
    ph = ph.astype(jnp.uint32)
    pl = pl.astype(jnp.uint32)
    is_max = (pl == EMPTY32) if narrow else (ph == EMPTY32) & (pl == EMPTY32)
    found = _device_search(table.keys, (pl,) if narrow else (ph, pl))
    return found, valid & ~is_max, valid & is_max


def range_join_count(kh, kl, vh, vl, ph, pl, nb_valid, np_valid, *,
                     narrow: bool = False):
    """Fused build+probe count.  Returns (count:i32, special4:u32)."""
    table = build_range_table(kh, kl, vh, vl, nb_valid, narrow=narrow,
                              with_values=False)
    found, ok, max_probe = _probe(table, ph, pl, np_valid, narrow)
    count = (jnp.sum((found >= 0) & ok, dtype=jnp.int32)
             + jnp.sum(max_probe, dtype=jnp.int32)
             * (table.special[0] > 0))
    return count.astype(jnp.int32), table.special


def range_join_materialize(kh, kl, vh, vl, ph, pl, nb_valid, np_valid, *,
                           narrow: bool = False,
                           narrow_values: bool = False):
    """Fused build+probe materialize: (count, out_kh, out_kl, out_vh,
    out_vl, special).  Matched rows are compacted in probe order."""
    from flash_hash_join_tpu.ops.compact import compact_by_mask

    table = build_range_table(kh, kl, vh, vl, nb_valid, narrow=narrow,
                              with_values=True, narrow_values=narrow_values)
    found, ok, max_probe = _probe(table, ph, pl, np_valid, narrow)
    sp_hit = max_probe & (table.special[0] > 0)
    hit = ((found >= 0) & ok) | sp_hit
    idx = jnp.maximum(found, 0)
    vals = [jnp.where(sp_hit, table.special[2], table.values[-1][idx])]
    if not narrow_values:
        vals.insert(0, jnp.where(sp_hit, table.special[1],
                                 table.values[0][idx]))
    keys = [pl.astype(jnp.uint32)] if narrow else [ph.astype(jnp.uint32),
                                                   pl.astype(jnp.uint32)]
    # identically-zero planes (narrow keys/values) stay out of compaction
    count, outs = compact_by_mask(hit, tuple(keys + vals))
    outs = list(outs)
    zeros = jnp.zeros(ph.shape, jnp.uint32)
    out_kh = zeros if narrow else outs.pop(0)
    out_kl = outs.pop(0)
    out_vh = zeros if narrow_values else outs.pop(0)
    out_vl = outs.pop(0)
    return count, out_kh, out_kl, out_vh, out_vl, table.special
