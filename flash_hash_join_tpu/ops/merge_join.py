"""Sort-merge join on hash order — the gather-free join strategy.

One sort replaces the table: for one-shot joins where the build side is a
sizable fraction of the probe side, the join needs no table at all:

  1. concat build and probe rows, tagged with a side flag,
  2. one lax.sort by (hash, key_hi, key_lo, flag) — build rows sort before
     probe rows within each equal-key run,
  3. a segmented doubling scan propagates "run contains a build row" and the
     FIRST build value through each run (ops/segmented.py),
  4. count = popcount of probe rows whose run has a build row;
     materialize = compact those rows (first-match semantics preserved:
     <=1 output per probe row, value = first build occurrence).

This has no analog in the reference (its radix path always builds per-
partition tables, hash_join.cpp:316-381) — here the sort IS the hash table.  Semantics contract (SURVEY.md §3) is identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from flash_hash_join_tpu.ops.hashing import hash_u64
from flash_hash_join_tpu.ops.segmented import segmented_scan, seg_starts


def _sorted_runs(kh, kl, vh, vl, ph, pl, nb_valid, np_valid):
    """Sort both sides together; returns per-row run info.

    Validity: invalid rows get flag=2 and hash 0xFFFFFFFF so they sort into
    a dead run at the end (their keys are forced to a reserved pattern that
    cannot equal any valid key's sort position within a run of real keys —
    we instead exclude them via the flag when counting/propagating).
    """
    nb, npr = kh.shape[0], ph.shape[0]
    bvalid = jnp.arange(nb, dtype=jnp.int32) < nb_valid
    pvalid = jnp.arange(npr, dtype=jnp.int32) < np_valid

    valid_all = jnp.concatenate([bvalid, pvalid])
    ch = jnp.concatenate([kh.astype(jnp.uint32), ph.astype(jnp.uint32)])
    cl = jnp.concatenate([kl.astype(jnp.uint32), pl.astype(jnp.uint32)])
    # Sanitize invalid rows' keys so they can never share a (hash, key) run
    # with a valid row by accident (they are also excluded by flag).
    ch = jnp.where(valid_all, ch, jnp.uint32(0xFFFFFFFF))
    cl = jnp.where(valid_all, cl, jnp.uint32(0xFFFFFFFF))
    cv_h = jnp.concatenate([vh.astype(jnp.uint32), jnp.zeros((npr,), jnp.uint32)])
    cv_l = jnp.concatenate([vl.astype(jnp.uint32), jnp.zeros((npr,), jnp.uint32)])
    # flag: 0 = build, 1 = probe, 2 = invalid (either side)
    flag = jnp.concatenate([
        jnp.where(bvalid, jnp.uint32(0), jnp.uint32(2)),
        jnp.where(pvalid, jnp.uint32(1), jnp.uint32(2)),
    ])
    # input row within its side: the last sort key, so equal-key build
    # rows keep input order and the run's first build row is the first
    # input occurrence
    orig = jnp.concatenate([
        jnp.arange(nb, dtype=jnp.int32),
        jnp.arange(npr, dtype=jnp.int32),
    ])

    h = hash_u64(ch, cl)
    h = jnp.where(flag == 2, jnp.uint32(0xFFFFFFFF), h)

    hs, chs, cls, fs, origs, vhs, vls = jax.lax.sort(
        (h, ch, cl, flag, orig, cv_h, cv_l), num_keys=5, is_stable=False
    )

    newk = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (chs[1:] != chs[:-1]) | (cls[1:] != cls[:-1]) | (hs[1:] != hs[:-1]),
    ])
    segid = jnp.cumsum(newk.astype(jnp.int32)) - 1

    is_build = fs == 0
    # propagate (has_build, first build value) through each run; build rows
    # sort first within a run, so any probe row sees them.
    def comb(a, b):
        ha, vha, vla = a
        hb, vhb, vlb = b
        keep_a = ha > 0
        return (jnp.maximum(ha, hb),
                jnp.where(keep_a, vha, vhb),
                jnp.where(keep_a, vla, vlb))

    hasb, bvh, bvl = segmented_scan(
        comb,
        (is_build.astype(jnp.uint32),
         jnp.where(is_build, vhs, jnp.uint32(0)),
         jnp.where(is_build, vls, jnp.uint32(0))),
        segid,
    )
    probe_match = (fs == 1) & (hasb > 0)
    return probe_match, chs, cls, bvh, bvl, origs


def merge_join_count(kh, kl, vh, vl, ph, pl, nb_valid, np_valid):
    probe_match, *_ = _sorted_runs(kh, kl, vh, vl, ph, pl, nb_valid, np_valid)
    return jnp.sum(probe_match).astype(jnp.int32)


def merge_join_materialize(kh, kl, vh, vl, ph, pl, nb_valid, np_valid):
    """Returns (count, out_kh, out_kl, out_vh, out_vl) — matched rows
    compacted to the front, ordered by (hash, key) (deterministic; the
    probe-order contract is restored by the caller via the orig index if
    needed — reference output order is thread-interleaved/nondeterministic,
    SURVEY.md §3, so any deterministic order is strictly stronger)."""
    probe_match, chs, cls, bvh, bvl, origs = _sorted_runs(
        kh, kl, vh, vl, ph, pl, nb_valid, np_valid)
    npr = ph.shape[0]
    from flash_hash_join_tpu.ops.compact import compact_by_mask
    count, outs = compact_by_mask(probe_match, (chs, cls, bvh, bvl),
                                  n_out=npr)
    return (count, *outs)
