"""Differential fuzzer: random joins vs the host oracle, all strategies.

Random shapes x key distributions x value widths x strategies, each checked
for count parity, key-multiset parity, and (key, value)-pair membership
against csrc's exact oracle.  Failures print a reproducer seed line.

Run: python scripts/fuzz_join.py [--iters 200] [--seed 0]  (CPU by default)
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# On-device fuzzing reuses a fixed shape set so each (shape, strategy,
# mode) graph compiles once and the iterations exercise compiled programs,
# not the compiler; distributions/seeds/values still vary per iteration.
FIXED_SHAPES = [(7, 100_000), (1_000, 5_000), (30_000, 60_000),
                (50_000, 50_000), (65_536, 131_072), (200_000, 400_000),
                (40_000, 262_144), (16_385, 262_144), (63_488, 133_000),
                (40_000, 131_073),   # odd probe lengths (padding paths)
                (400_000, 400_000)]  # large dense domains (dense_wide)


def gen_case(rng, fixed_shapes=False):
    if fixed_shapes:
        nb, npr = FIXED_SHAPES[int(rng.integers(0, len(FIXED_SHAPES)))]
    # mostly small/medium, occasionally large (deep binary searches,
    # multi-word bitmaps, retry ladders)
    elif rng.integers(0, 4) == 0:
        nb = int(rng.integers(20_000, 300_000))
        npr = int(rng.integers(1, 500_000))
    else:
        nb = int(rng.integers(1, 60_000))
        npr = int(rng.integers(1, 120_000))
    dist = rng.choice(["uniform", "narrow", "dense", "zipf", "dup_heavy",
                       "sentinel", "tiny_universe", "dense_wide"])
    if dist == "uniform":
        bk = rng.integers(0, 2**63, nb, dtype=np.uint64)
        pk = rng.integers(0, 2**63, npr, dtype=np.uint64)
    elif dist == "narrow":
        u = int(rng.integers(2, 2**31))
        bk = rng.integers(0, u, nb, dtype=np.uint64)
        pk = rng.integers(0, u, npr, dtype=np.uint64)
    elif dist == "dense":
        base = int(rng.integers(0, 2**40))
        bk = (rng.integers(0, max(nb // 2, 2), nb) + base).astype(np.uint64)
        pk = rng.integers(0, 2**41, npr, dtype=np.uint64)
    elif dist == "zipf":
        bk = np.minimum(rng.zipf(1.3, nb), 2**50).astype(np.uint64)
        pk = np.minimum(rng.zipf(1.3, npr), 2**50).astype(np.uint64)
    elif dist == "dup_heavy":
        uniq = max(int(rng.integers(1, 50)), 1)
        pool = rng.integers(0, 2**62, uniq, dtype=np.uint64)
        bk = rng.choice(pool, nb)
        pk = rng.choice(pool, npr)
    elif dist == "sentinel":
        bk = rng.integers(0, 1000, nb, dtype=np.uint64)
        pk = rng.integers(0, 1200, npr, dtype=np.uint64)
        for arr in (bk, pk):
            hits = rng.integers(0, len(arr), max(len(arr) // 50, 1))
            arr[hits] = rng.choice(
                np.array([2**64 - 1, 2**32 - 1, 0], np.uint64), len(hits))
    elif dist == "dense_wide":
        # spans past 2^20 slots (several bitmap words per build row);
        # occasionally carve a wide key-space gap into the domain.  Random
        # mode pins ONE canonical shape so CPU runs reuse a single compile
        # per strategy; the fixed-shapes run covers the big band
        if not fixed_shapes:
            nb, npr = 40_000, 65_536
            span = int(rng.integers((1 << 20) + 1, 1 << 21))
        else:
            span = int(rng.integers((1 << 20) + 1, 1 << 22))
        base = int(rng.integers(0, 2**31))
        bk = (rng.integers(0, span, nb) + base).astype(np.uint64)
        pk = (rng.integers(0, int(span * 1.2) + 1, npr) + base).astype(
            np.uint64)
        if rng.integers(0, 3) == 0:
            lo, hi = int(span * 0.3), int(span * 0.9)
            for arr in (bk, pk):
                m = (arr - base >= lo) & (arr - base < hi)
                arr[m] += np.uint64(hi - lo)
    else:  # tiny_universe
        u = int(rng.integers(1, 6))
        bk = rng.integers(0, u, nb, dtype=np.uint64)
        pk = rng.integers(0, u + 2, npr, dtype=np.uint64)
    if bool(rng.integers(0, 2)):
        bv = rng.integers(0, 2**31, nb, dtype=np.uint64)   # narrow values
    else:
        bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    return dist, bk, bv, pk


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fixed-shapes", action="store_true",
                    help="draw shapes from FIXED_SHAPES (compile reuse; "
                         "use for on-device fuzzing)")
    ap.add_argument("--chunked", action="store_true",
                    help="force host-side probe-chunk streaming (2-4 "
                         "chunks, overlap + serial alternating) on every "
                         "adaptive/partitioned iteration — exercises the "
                         "padded-tail + concat paths of api._run_chunked")
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    import flash_hash_join_tpu as fj
    from flash_hash_join_tpu.utils.native import host_join_materialize

    if args.chunked:
        import dataclasses

        from flash_hash_join_tpu.engine import JoinEngine

        real_plan = JoinEngine.plan
        state = {"chunks": 2}

        def chunked_plan(self, nb, npr, mode="count"):
            p = real_plan(self, nb, npr, mode)
            if npr >= 4_096 and p.probe_chunks == 1:
                p = dataclasses.replace(p, probe_chunks=state["chunks"])
            return p

        JoinEngine.plan = chunked_plan

    strategies = ["adaptive", "partitioned", "merge", "global", "direct"]
    t0 = time.time()
    fails = 0
    for it in range(args.iters):
        seed = args.seed + it
        rng = np.random.default_rng(seed)
        dist, bk, bv, pk = gen_case(rng, args.fixed_shapes)
        ok_ref, ov_ref = host_join_materialize(bk, bv, pk)
        want = len(ok_ref)
        want_keys = collections.Counter(ok_ref.tolist())
        pairs = set(zip(bk.tolist(), bv.tolist()))
        strat = strategies[it % len(strategies)]
        if strat == "direct":
            from flash_hash_join_tpu.ops import direct_bitmap as db
            bmax = int(bk.max())
            span = bmax - int(bk.min()) + 1
            if not (bmax < 2**32 and span <= db.MAX_DOMAIN_SLOTS):
                strat = "merge"
        mat_strat = strat
        if args.chunked:
            # alternate chunk counts and overlap/serial across iterations;
            # keep shapes' chunk GEOMETRY stable for compile reuse
            state["chunks"] = 2 + (it % 3)
            os.environ["FHJ_CHUNK_OVERLAP"] = "01"[it % 2]
        try:
            c, _ = fj.join_count(bk, bv, pk, strategy=strat)
            assert c == want, f"count {c} != {want}"
            c2, _, keys, vals = fj.join_materialize(
                bk, bv, pk, strategy=mat_strat, return_arrays=True)
            assert c2 == want, f"mat count {c2} != {want}"
            assert collections.Counter(keys.tolist()) == want_keys, \
                "key multiset"
            bad = [p for p in zip(keys.tolist(), vals.tolist())
                   if p not in pairs]
            assert not bad, f"bad pairs {bad[:3]}"
        except Exception as e:
            fails += 1
            print(f"FAIL seed={seed} dist={dist} strat={strat} "
                  f"nb={len(bk)} npr={len(pk)}: {e}", flush=True)
        if (it + 1) % 20 == 0:
            print(f"[{it+1}/{args.iters}] {time.time()-t0:.0f}s "
                  f"fails={fails}", flush=True)
    print(f"DONE {args.iters} iters, {fails} failures")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
