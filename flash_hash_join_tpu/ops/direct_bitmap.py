"""Direct-address joins for dense narrow key domains.

The adaptive tier's answer to the reference's count and materialize cells
(hash_join.cpp:498-534 radix count, :536-567 scalar count, :394-444
materialize) when the build keys are dense integers — exactly the
db-benchmark J1 shape, where the build side is an id column over
[0, ~1.1*nb).  DuckDB's perfect-hash join exploits the same statistic:
with lo = min(build key), key k lives at domain slot k - lo, so the join
needs neither a sort nor a hash table.

  count       — one scatter builds a bitmap of the occupied slots (packed
                into u32 words: 2^27 slots are 16 MB), one gather + shift
                per probe reads it.  First-match semantics: each probe row
                counts at most once, whatever the build duplicates.
  materialize — one scatter-min writes each slot's winning build row (the
                FIRST input occurrence, the rule of every other tier), one
                gather per probe reads it, and the values come from the
                build planes at that row.  Output in probe order.

Split of work:
  host (api.py): `dense_domain_ok` decides from the numpy inputs, and
    d_rows_for / v_rows_for pick the compile rung for the domain size.
  this module (in-graph): everything else.

Exactness: build rows that do not fit the declared domain (key hi-word
!= 0, or slot >= the rung's size — impossible when api.py sized the rung
from the true span, possible under the chained-timing key remix) are
counted into special[3], and the caller's retry ladder reruns on the
always-exact merge path.  Probe keys outside the domain are provably
matchless and contribute zero.
"""

from __future__ import annotations

import jax.numpy as jnp

LANES = 128
BITS_PER_ROW = 32 * LANES   # count rung: one row = 128 u32 bitmap words
SENTINEL = 0xFFFFFFFF

# The one routing rule (api.py): a build side is DENSE when its keys fit
# 32 bits and their span is at most DENSE_SLOTS_PER_ROW slots per input
# row (build + probe), capped at MAX_DOMAIN_SLOTS.  The direct graphs then
# move O(span) bytes of domain state beside O(rows) of gathers and never
# sort, which is what chip_smoke.py's J1 phase compares against the
# partitioned tier on the card.  The cap bounds the materialize row plane
# (4 bytes per slot) at 4 GiB.
DENSE_SLOTS_PER_ROW = 4
MAX_DOMAIN_SLOTS = 1 << 30


def dense_domain_ok(span: int, nb: int, npr: int) -> bool:
    """The direct-vs-partitioned rule for a build key span of `span`."""
    return span <= min(DENSE_SLOTS_PER_ROW * (nb + npr), MAX_DOMAIN_SLOTS)


def _pow2_rows(need: int) -> int:
    r = 8
    while r < need:
        r *= 2
    return r


def d_rows_for(span: int) -> int:
    """Count compile rung: bitmap rows of 4096 slots, pow2 so shapes cache."""
    return _pow2_rows(-(-max(span, 1) // BITS_PER_ROW))


def v_rows_for(span: int) -> int:
    """Materialize compile rung: pow2 rows of 128 slots."""
    return _pow2_rows(-(-max(span, 1) // LANES))


def _domain(kh, kl, nb_valid, slots: int):
    """(lo, build slot or `slots` when out of domain/invalid, n_bad)."""
    n = kh.shape[0]
    bvalid = jnp.arange(n, dtype=jnp.int32) < nb_valid
    lo = jnp.min(jnp.where(bvalid & (kh == 0), kl, jnp.uint32(SENTINEL)),
                 initial=jnp.uint32(SENTINEL))
    diff = kl - lo                        # u32; keys < lo wrap to huge
    bad = bvalid & ((kh != 0) | (diff >= slots))
    n_bad = jnp.sum(bad).astype(jnp.uint32)
    return lo, jnp.where(bvalid & ~bad, diff, jnp.uint32(slots)), n_bad


def _probe_slot(ph, pl, np_valid, lo, slots: int):
    """(probe slot clipped into the domain, in-domain mask)."""
    npr = ph.shape[0]
    pvalid = jnp.arange(npr, dtype=jnp.int32) < np_valid
    pdiff = pl - lo
    pok = pvalid & (ph == 0) & (pdiff < slots)
    return jnp.where(pok, pdiff, 0).astype(jnp.int32), pok


def _special(n_bad):
    zero = jnp.uint32(0)
    return jnp.stack([zero, zero, zero, n_bad])


def direct_join_count(kh, kl, ph, pl, nb_valid, np_valid, *, d_rows: int):
    """In-graph dense-domain count.  Returns (count:i32, special4:u32).

    kh/kl, ph/pl: u32 hi/lo key planes (utils/u64.py SoA convention).
    special[3] = build rows outside the declared domain (caller must
    fall back when nonzero).
    """
    slots = d_rows * BITS_PER_ROW
    lo, bslot, n_bad = _domain(kh, kl, nb_valid, slots)
    bits = jnp.zeros((slots,), jnp.bool_).at[bslot].set(True, mode="drop")
    weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(bits.reshape(-1, 32).astype(jnp.uint32) * weights,
                    axis=1, dtype=jnp.uint32)
    pslot, pok = _probe_slot(ph, pl, np_valid, lo, slots)
    bit = (words[pslot >> 5] >> (pslot & 31).astype(jnp.uint32)) & 1
    count = jnp.sum(jnp.where(pok, bit, 0), dtype=jnp.int32)
    return count, _special(n_bad)


def direct_join_materialize(kh, kl, vh, vl, ph, pl, nb_valid, np_valid, *,
                            v_rows: int, narrow_values: bool = False):
    """In-graph dense-domain materialize.  Returns the engine materialize
    contract (count, out_kh, out_kl, out_vh, out_vl, special4), matched
    rows in probe order.  special[3] = build rows outside the domain."""
    from flash_hash_join_tpu.ops.compact import compact_by_mask

    n = kh.shape[0]
    slots = v_rows * LANES
    lo, bslot, n_bad = _domain(kh, kl, nb_valid, slots)
    rows = jnp.arange(n, dtype=jnp.int32)
    win = jnp.full((slots,), n, jnp.int32).at[bslot].min(rows, mode="drop")
    pslot, pok = _probe_slot(ph, pl, np_valid, lo, slots)
    row = win[pslot]
    hit = pok & (row < n)
    row = jnp.minimum(row, n - 1)
    cols = [pl.astype(jnp.uint32)]
    if not narrow_values:
        cols.append(vh[row].astype(jnp.uint32))
    cols.append(vl[row].astype(jnp.uint32))
    # matched probe keys have hi == 0 (in-domain), so only lo is compacted
    count, outs = compact_by_mask(hit, tuple(cols))
    zeros = jnp.zeros(ph.shape, jnp.uint32)
    out_vh = zeros if narrow_values else outs[1]
    return (count, zeros, outs[0], out_vh, outs[-1], _special(n_bad))
