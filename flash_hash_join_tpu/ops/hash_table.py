"""Open-addressing hash table: sort-based build, gather-based probe.

Reference semantics being reproduced (SURVEY.md §3 "Semantics contract",
hash_join.cpp:75-204):
  * linear-probing open addressing at ~<=0.5 load factor,
  * duplicate build keys: exactly one winner row survives (first-writer-wins
    at hash_join.cpp:125,:147 — arbitrary winner; ours is deterministic:
    first occurrence in (home, key) sort order),
  * probe emits at most ONE match per probe key (break at hash_join.cpp:177),
  * full table drops excess keys silently (hash_join.cpp:149) — we drop keys
    whose chain would exceed the overflow margin, and report the drop count.

Mechanism (none of the reference's mechanics survive):
  * No CAS / atomics (hash_join.cpp:130-151).  Build = hash -> sort rows by
    home bucket (lax.sort) -> canonical linear-probe slots via a cummax scan
    -> ONE conflict-free scatter.  The classic fact that a linear-probing
    table's occupied-slot set is insertion-order independent makes the sorted
    construction exact.
  * No per-slot AoS structs (hash_join.cpp:80-86).  Slots live in bucketized
    SoA rows: group g's 8 slots are one contiguous (2*G,) uint32 row
    [hi_0..hi_7, lo_0..lo_7] = 64 bytes = two 32-byte memory sectors per probe touch.
  * No scalar probe loop (hash_join.cpp:169-179).  Probe gathers whole groups
    for a chunk of keys at once and resolves matches with masked vector
    compares; rare overflow chains continue in a masked while_loop.
  * u64 keys/values are (hi, lo) uint32 pairs throughout (utils/u64.py).

Empty slots are encoded as key == 2**64-1.  A *real* key of that value is
never stored; it is resolved exactly through the `special` side channel so
no mid-chain slot can masquerade as empty.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from flash_hash_join_tpu.ops.hashing import hash_u64, bloom_word

EMPTY32 = np.uint32(0xFFFFFFFF)  # numpy: importing this module must not init the XLA backend
#           (jax.distributed.initialize ordering, scripts/multihost_worker.py)
_NEG_LARGE = -(2 ** 30)  # cast at use: no jnp at import time


class HashTable(NamedTuple):
    """Built join hash table (all device arrays; static meta passed separately).

    keys: (total_groups, 2*G) uint32 — group-major slot keys, hi then lo.
    vals: (total_groups, 2*G) uint32 — payload halves, same layout.
    bloom: (total_groups,) uint32 — per-group bloom words (zeros((1,)) if off).
    special: (4,) uint32 — [has_max_key, max_val_hi, max_val_lo, n_dropped].
    """

    keys: jnp.ndarray
    vals: jnp.ndarray
    bloom: jnp.ndarray
    special: jnp.ndarray


def home_group(h: jnp.ndarray, gbits: int, pre_shift: int = 0) -> jnp.ndarray:
    """Home group from the TOP gbits of the hash (nests under partition ids).

    pre_shift discards that many top hash bits first: a shard of a
    hash-partitioned table (distributed shuffle or radix partition) receives
    keys that all share their top `pre_shift` bits, so its local table must
    bucket on the bits below (parallel/distributed_join.py).
    """
    h = h << jnp.uint32(pre_shift)
    return (h >> jnp.uint32(32 - gbits)).astype(jnp.uint32)


def build_table(
    kh: jnp.ndarray,
    kl: jnp.ndarray,
    vh: jnp.ndarray,
    vl: jnp.ndarray,
    n_valid: jnp.ndarray | int,
    *,
    gbits: int,
    group_size: int,
    overflow_groups: int,
    with_bloom: bool,
    bloom_k: int = 3,
    pre_shift: int = 0,
    valid_mask: jnp.ndarray | None = None,
    max_probe_iters: int | None = None,
) -> HashTable:
    """Build the table from (possibly padded) u32-pair key/value columns.

    Rows at index >= n_valid are padding and ignored (padding lets callers
    bucket shapes and lets the distributed shuffle use fixed-size buckets).

    Replaces the reference's build_concurrent CAS loop (hash_join.cpp:130-151,
    :193-203) with sort + scan + one conflict-free scatter.
    """
    n = kh.shape[0]
    G = group_size
    ngroups = 1 << gbits
    ntot = ngroups + overflow_groups
    n_valid = jnp.asarray(n_valid, jnp.int32)

    row_valid = jnp.arange(n, dtype=jnp.int32) < n_valid
    if valid_mask is not None:
        row_valid = row_valid & valid_mask
    # Force padding rows to the MAX sentinel: they are excluded from placement
    # by the is_max rule below, uniformly with genuine 2**64-1 keys.
    kh = jnp.where(row_valid, kh.astype(jnp.uint32), EMPTY32)
    kl = jnp.where(row_valid, kl.astype(jnp.uint32), EMPTY32)
    vh = vh.astype(jnp.uint32)
    vl = vl.astype(jnp.uint32)

    # --- special side channel for the sentinel key (exactness, no dropped key)
    is_max_in = (kh == EMPTY32) & (kl == EMPTY32) & row_valid
    has_max = jnp.any(is_max_in)
    # first-occurrence value of the MAX key (first-writer-wins dedup)
    first_max = jnp.argmax(is_max_in)  # 0 if none; guarded by has_max
    max_vh = jnp.where(has_max, vh[first_max], jnp.uint32(0))
    max_vl = jnp.where(has_max, vl[first_max], jnp.uint32(0))

    h = hash_u64(kh, kl)
    home = home_group(h, gbits, pre_shift)

    # Sort rows by (home, key) so equal keys are adjacent (exact dedup) and
    # placement order is canonical.  5-operand single sort; stability gives a
    # deterministic dedup winner (reference winner is race-dependent).
    home_s, kh_s, kl_s, vh_s, vl_s = jax.lax.sort(
        (home, kh, kl, vh, vl), num_keys=3, is_stable=True
    )

    is_max_s = (kh_s == EMPTY32) & (kl_s == EMPTY32)
    first_occ = jnp.concatenate(
        [
            jnp.ones((1,), jnp.bool_),
            (kh_s[1:] != kh_s[:-1]) | (kl_s[1:] != kl_s[:-1]),
        ]
    )
    keep = first_occ & ~is_max_s

    # Canonical linear-probe placement over kept rows only:
    #   rank r_i = #kept rows before i;  slot_i = r_i + cummax(home_slot - r)
    # For kept rows this equals inserting in sorted order with linear probing
    # (every slot in [home_slot_i, slot_i) is occupied by an earlier kept row).
    rank = jnp.cumsum(keep.astype(jnp.int32)) - 1
    home_slot = home_s.astype(jnp.int32) * G
    cand = jnp.where(keep, home_slot - rank, _NEG_LARGE)
    slot = rank + jax.lax.cummax(cand)

    max_slot = ntot * G
    in_range = slot < max_slot
    place = keep & in_range
    n_dropped = jnp.sum(keep & ~in_range).astype(jnp.uint32)
    if max_probe_iters is not None:
        # A placed key whose probe chain spans >= max_probe_iters groups is
        # unreachable by the bounded probe loop (_probe_chunk_state gives up
        # after max_iters groups).  Count such keys as dropped so callers'
        # exact-fallback rerun (api.py on special[3] != 0) also covers
        # adversarial chains that stay inside the table.
        chain_groups = slot // G - home_s.astype(jnp.int32)
        unreachable = place & (chain_groups >= max_probe_iters)
        n_dropped = n_dropped + jnp.sum(unreachable).astype(jnp.uint32)

    g_idx = slot // G
    j_idx = slot - g_idx * G
    flat_hi = g_idx * (2 * G) + j_idx
    flat_lo = flat_hi + G
    # Distinct out-of-bounds indices for dropped rows keep unique_indices valid.
    oob = max_slot * 2 + jnp.arange(n, dtype=jnp.int32)
    flat_hi = jnp.where(place, flat_hi, oob)
    flat_lo = jnp.where(place, flat_lo, oob)

    keys_flat = jnp.full((ntot * 2 * G,), EMPTY32, jnp.uint32)
    keys_flat = keys_flat.at[flat_hi].set(kh_s, mode="drop", unique_indices=True)
    keys_flat = keys_flat.at[flat_lo].set(kl_s, mode="drop", unique_indices=True)
    vals_flat = jnp.zeros((ntot * 2 * G,), jnp.uint32)
    vals_flat = vals_flat.at[flat_hi].set(vh_s, mode="drop", unique_indices=True)
    vals_flat = vals_flat.at[flat_lo].set(vl_s, mode="drop", unique_indices=True)

    if with_bloom:
        # Per-group OR of bloom signatures via a segmented scan over the
        # sorted rows (replaces the reference's atomic fetch_or into the
        # bloom directory, hash_join.cpp:122,:142).  Padding/MAX rows were
        # remapped to the sentinel key; their signature bits are harmless
        # only if excluded, so mask their tags to 0.
        h_s = hash_u64(kh_s, kl_s)
        tag = jnp.where(~is_max_s, bloom_word(h_s, bloom_k), jnp.uint32(0))
        from flash_hash_join_tpu.ops.segmented import segmented_scan
        tag_scan = segmented_scan(lambda a, b: a | b, tag, home_s)
        seg_end = jnp.concatenate(
            [home_s[1:] != home_s[:-1], jnp.ones((1,), jnp.bool_)]
        )
        bloom_idx = jnp.where(
            seg_end, home_s.astype(jnp.int32), ntot + jnp.arange(n, dtype=jnp.int32)
        )
        bloom = jnp.zeros((ntot,), jnp.uint32)
        bloom = bloom.at[bloom_idx].set(tag_scan, mode="drop", unique_indices=True)
    else:
        bloom = jnp.zeros((1,), jnp.uint32)

    special = jnp.stack(
        [has_max.astype(jnp.uint32), max_vh, max_vl, n_dropped]
    )
    return HashTable(
        keys=keys_flat.reshape(ntot, 2 * G),
        vals=vals_flat.reshape(ntot, 2 * G),
        bloom=bloom,
        special=special,
    )


def _probe_chunk_state(
    table: HashTable,
    ph: jnp.ndarray,
    pl: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    gbits: int,
    group_size: int,
    total_groups: int,
    use_bloom: bool,
    bloom_k: int,
    max_iters: int,
    pre_shift: int = 0,
):
    """Resolve one chunk of probe keys; returns (matched, g_found, j_found,
    sp_match) — enough for both count and materialize callers."""
    G = group_size
    ntot = total_groups
    n = ph.shape[0]
    ph = ph.astype(jnp.uint32)
    pl = pl.astype(jnp.uint32)

    h = hash_u64(ph, pl)
    g = home_group(h, gbits, pre_shift).astype(jnp.int32)

    has_max = table.special[0] > 0
    is_max = (ph == EMPTY32) & (pl == EMPTY32)
    sp_match = is_max & has_max & valid

    if use_bloom:
        w = table.bloom[g]
        tag = bloom_word(h, bloom_k)
        pruned = (w & tag) != tag
    else:
        pruned = jnp.zeros((n,), jnp.bool_)

    done = (~valid) | is_max | pruned
    matched = jnp.zeros((n,), jnp.bool_)
    g_found = jnp.zeros((n,), jnp.int32)
    j_found = jnp.zeros((n,), jnp.int32)

    def cond(st):
        it, done, *_ = st
        return (it < max_iters) & ~jnp.all(done)

    def body(st):
        it, done, matched, g, g_found, j_found = st
        window = table.keys[g]  # (n, 2G) gather: one 64B row per probe key
        wh = window[:, :G]
        wl = window[:, G:]
        eq = (wh == ph[:, None]) & (wl == pl[:, None])
        emp = (wh == EMPTY32) & (wl == EMPTY32)
        found = jnp.any(eq, axis=1)
        has_empty = jnp.any(emp, axis=1)
        jloc = jnp.argmax(eq, axis=1).astype(jnp.int32)

        new_found = ~done & found
        matched = matched | new_found
        g_found = jnp.where(new_found, g, g_found)
        j_found = jnp.where(new_found, jloc, j_found)

        done = done | found | has_empty
        g_next = jnp.minimum(g + 1, ntot - 1)
        done = done | (g_next == g)  # chain ran off the table end: absent
        g = jnp.where(done, g, g_next)
        return (it + 1, done, matched, g, g_found, j_found)

    st0 = (jnp.int32(0), done, matched, g, g_found, j_found)
    _, _, matched, _, g_found, j_found = jax.lax.while_loop(cond, body, st0)
    return matched, g_found, j_found, sp_match


def probe_count_chunk(table, ph, pl, valid, **static) -> jnp.ndarray:
    matched, _, _, sp_match = _probe_chunk_state(table, ph, pl, valid, **static)
    return jnp.sum(matched | sp_match).astype(jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)


def probe_materialize_chunk(table, ph, pl, valid, **static):
    """Returns (matched, out_vh, out_vl) for one chunk (first-match value)."""
    G = static["group_size"]
    matched, g_found, j_found, sp_match = _probe_chunk_state(
        table, ph, pl, valid, **static
    )
    vwin = table.vals[g_found]  # (n, 2G); only matched lanes meaningful
    vh = jnp.take_along_axis(vwin[:, :G], j_found[:, None], axis=1)[:, 0]
    vl = jnp.take_along_axis(vwin[:, G:], j_found[:, None], axis=1)[:, 0]
    vh = jnp.where(sp_match, table.special[1], vh)
    vl = jnp.where(sp_match, table.special[2], vl)
    all_matched = matched | sp_match
    return all_matched, vh, vl


def probe_count(
    table: HashTable,
    ph: jnp.ndarray,
    pl: jnp.ndarray,
    n_valid: jnp.ndarray | int,
    *,
    probe_chunk: int,
    valid_mask: jnp.ndarray | None = None,
    **static,
) -> jnp.ndarray:
    """Count probe keys present in the table (reference count semantics:
    probe multiplicity counts, build multiplicity does not).

    Processes the probe stream in fixed chunks via lax.scan — the analog
    of the reference's 2048-key morsels (hash_join.cpp:302) — so the gather
    window stays bounded regardless of probe length.
    """
    n = ph.shape[0]
    n_valid = jnp.asarray(n_valid, jnp.int32)
    chunk = min(probe_chunk, n) if n > 0 else 1
    if n == 0:
        return jnp.int32(0)
    if valid_mask is None:
        valid_mask = jnp.ones((n,), jnp.bool_)
    if n % chunk != 0:
        pad = chunk - n % chunk
        ph = jnp.concatenate([ph, jnp.full((pad,), EMPTY32, jnp.uint32)])
        pl = jnp.concatenate([pl, jnp.full((pad,), EMPTY32, jnp.uint32)])
        valid_mask = jnp.concatenate([valid_mask, jnp.zeros((pad,), jnp.bool_)])
    nchunks = ph.shape[0] // chunk
    ph = ph.reshape(nchunks, chunk)
    pl = pl.reshape(nchunks, chunk)
    valid_mask = valid_mask.reshape(nchunks, chunk)
    bases = jnp.arange(nchunks, dtype=jnp.int32) * chunk
    lane = jnp.arange(chunk, dtype=jnp.int32)

    def step(acc, xs):
        base, ph_c, pl_c, vm_c = xs
        valid = ((base + lane) < n_valid) & vm_c
        c = probe_count_chunk(table, ph_c, pl_c, valid, **static)
        return acc + c.astype(jnp.int32), None

    total, _ = jax.lax.scan(step, jnp.int32(0), (bases, ph, pl, valid_mask))
    return total


def probe_materialize(
    table: HashTable,
    ph: jnp.ndarray,
    pl: jnp.ndarray,
    n_valid: jnp.ndarray | int,
    *,
    probe_chunk: int,
    valid_mask: jnp.ndarray | None = None,
    **static,
):
    """Materialize (probe_key, build_value) pairs for matching probe keys.

    Two-phase-free design: a single probe pass per chunk computes matches and
    values, then a cumsum gives exact in-chunk offsets and a scatter compacts
    rows into the output at the running global offset.  Output arrays are
    sized n (upper bound: <=1 match per probe key, same bound the reference
    uses for its thread-local vectors, hash_join.cpp:330-339); `count` rows
    are valid.  Matched rows appear in probe order (deterministic, unlike the
    reference's thread-interleaved output).
    """
    n = ph.shape[0]
    n_valid = jnp.asarray(n_valid, jnp.int32)
    chunk = min(probe_chunk, n) if n > 0 else 1
    zero = jnp.zeros((0,), jnp.uint32)
    if n == 0:
        return jnp.int32(0), zero, zero, zero, zero
    if valid_mask is None:
        valid_mask = jnp.ones((n,), jnp.bool_)
    npad = n if n % chunk == 0 else n + (chunk - n % chunk)
    if npad != n:
        pad = npad - n
        ph = jnp.concatenate([ph, jnp.full((pad,), EMPTY32, jnp.uint32)])
        pl = jnp.concatenate([pl, jnp.full((pad,), EMPTY32, jnp.uint32)])
        valid_mask = jnp.concatenate([valid_mask, jnp.zeros((pad,), jnp.bool_)])
    nchunks = npad // chunk
    phc = ph.reshape(nchunks, chunk)
    plc = pl.reshape(nchunks, chunk)
    vmc = valid_mask.reshape(nchunks, chunk)
    bases = jnp.arange(nchunks, dtype=jnp.int32) * chunk
    lane = jnp.arange(chunk, dtype=jnp.int32)

    out_kh = jnp.zeros((npad,), jnp.uint32)
    out_kl = jnp.zeros((npad,), jnp.uint32)
    out_vh = jnp.zeros((npad,), jnp.uint32)
    out_vl = jnp.zeros((npad,), jnp.uint32)

    def step(carry, xs):
        offset, out_kh, out_kl, out_vh, out_vl = carry
        base, ph_c, pl_c, vm_c = xs
        valid = ((base + lane) < n_valid) & vm_c
        matched, vh, vl = probe_materialize_chunk(
            table, ph_c, pl_c, valid, **static
        )
        pos_in = jnp.cumsum(matched.astype(jnp.int32)) - 1
        pos = offset + pos_in
        idx = jnp.where(matched, pos, npad + lane)
        out_kh = out_kh.at[idx].set(ph_c, mode="drop", unique_indices=True)
        out_kl = out_kl.at[idx].set(pl_c, mode="drop", unique_indices=True)
        out_vh = out_vh.at[idx].set(vh, mode="drop", unique_indices=True)
        out_vl = out_vl.at[idx].set(vl, mode="drop", unique_indices=True)
        offset = offset + jnp.sum(matched).astype(jnp.int32)
        return (offset, out_kh, out_kl, out_vh, out_vl), None

    carry0 = (jnp.int32(0), out_kh, out_kl, out_vh, out_vl)
    (count, out_kh, out_kl, out_vh, out_vl), _ = jax.lax.scan(
        step, carry0, (bases, phc, plc, vmc)
    )
    return count, out_kh[:n], out_kl[:n], out_vh[:n], out_vl[:n]
