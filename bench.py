"""Headline benchmark: count-only adaptive join throughput on the device.

Mirrors the reference's flagship measurement (BASELINE.md "derived anchors"):
adaptive_join_count on a Q5-shaped case (build rows == probe rows, uniform
uint64 keys, ~90% match rate like db-benchmark J1 big-table joins).
Baseline: reference CPU 4e7-Q5 count = 0.316 s ~= 127M probe rows/s
(benchmark_join_count.png, all cores).

Measurement: the headline is STEADY-STATE DEVICE TIME from
`fj.measure_device_seconds` — K count-preserving key-remixed joins chained
in one compiled scan, (t_chain - t_single)/(K-1) — which cancels the flat
per-call dispatch and fetch cost that the reference's in-process
SimpleTimer never sees (hash_join.cpp:45-55 starts after pybind
marshaling).  The conventional single-call API time is reported alongside
in `single_call_seconds`.  The JSON line names the device it ran on.

Prints exactly ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "...", "vs_baseline": N}
Diagnostics go to stderr.  Scale with --n (default 4e7 to match baseline).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

BASELINE_ROWS_PER_SEC = 4e7 / 0.316  # reference CPU anchor, 4e7-Q5 count


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=40_000_000,
                    help="build rows == probe rows (Q5 shape)")
    args = ap.parse_args()

    import jax
    log("devices:", jax.devices())
    import flash_hash_join_tpu as fj
    fj.initialize()

    n = args.n
    rng = np.random.default_rng(2026)
    # db-benchmark J1 Q5: big-table join, keys ~ uniform over ~1.1*n range
    build_keys = rng.integers(0, int(n * 1.1), n, dtype=np.uint64)
    build_values = rng.integers(0, 2**63, n, dtype=np.uint64)
    probe_keys = rng.integers(0, int(n * 1.1), n, dtype=np.uint64)
    if n <= 10_000_000:  # oracle check only at sizes where numpy is quick
        expected = int(np.isin(probe_keys, np.unique(build_keys)).sum())
        count, _ = fj.adaptive_join_count(build_keys, build_values,
                                          probe_keys)
        assert count == expected, (count, expected)

    count, dev_seconds, single, chained = fj.measure_device_seconds(
        build_keys, build_values, probe_keys, mode="count", number=3)
    log(f"count={count} steady-state device time: {dev_seconds:.4f}s "
        f"(single-call best {single:.4f}s, chained={chained})")

    rows_per_sec = n / dev_seconds
    print(json.dumps({
        "metric": f"adaptive_join_count probe rows/s ({n/1e6:.0f}M build x "
                  f"{n/1e6:.0f}M probe, Q5 shape, incl. build; steady-state "
                  "device time via chained-delta)",
        "value": round(rows_per_sec),
        "unit": "probe_rows_per_sec",
        "vs_baseline": round(rows_per_sec / BASELINE_ROWS_PER_SEC, 3),
        "device_seconds": round(dev_seconds, 4),
        "single_call_seconds": round(single, 4),
        "single_call_rows_per_sec": round(n / single),
        "chained": chained,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
