"""North-star benchmark: 1e8 x 1e8 join, count and materialize.

BASELINE.json's target is >= 1e9 probe rows/s/chip count-only on a 1e8-row
join; the reference CPU anchor is 127M rows/s at 4e7 (BASELINE.md).  This
script records where the engine actually is at 1e8 scale.

Run: python scripts/bench_northstar.py [--n 100000000] [--repeats 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import jax
    import flash_hash_join_tpu as fj

    log("devices:", jax.devices())
    fj.initialize()
    n = args.n
    rng = np.random.default_rng(7)
    bk = rng.integers(0, int(n * 1.1), n, dtype=np.uint64)
    bv = rng.integers(0, 2**63, n, dtype=np.uint64)
    pk = rng.integers(0, int(n * 1.1), n, dtype=np.uint64)

    for mode, fn in (("count", fj.adaptive_join_count),
                     ("materialize", fj.adaptive_join)):
        c, t = fn(bk, bv, pk)
        log(f"{mode} warmup: count={c} t={t:.4f}s")
        best = t
        for i in range(args.repeats):
            c2, t2 = fn(bk, bv, pk)
            assert c2 == c, (c2, c)
            best = min(best, t2)
            log(f"{mode} run {i}: {t2:.4f}s")
        print(json.dumps({
            "metric": f"adaptive_join_{mode} rows/s ({n/1e6:.0f}M x "
                      f"{n/1e6:.0f}M, incl. build)",
            "value": round(n / best),
            "unit": "probe_rows_per_sec",
            "seconds": round(best, 4),
        }), flush=True)


if __name__ == "__main__":
    main()
