"""On-card smoke test of the join engine, through the public entry points.

Runs every phase in one process on one GPU, with data made from --seed,
and checks every result exactly against the C++ host oracle
(utils/native.py): counts must be equal, materialized rows equal as
(key, value) multisets.

Phases (default, one card):
  j1        db-benchmark J1 at 1e8 probe rows (models/workload.j1_suite):
            Q1, Q2, Q5 x adaptive count and materialize, plus partitioned
            count for the direct-vs-partitioned rule.  Fails if an adaptive
            run ended on the merge fallback.  Prints each graph's
            memory_analysis() bytes per row.
  api       all 13 reference functions plus join_count/join_materialize
            with every strategy, at a 1e7 x 1e7 Q5 shape, with sparse
            64-bit keys and with 32-bit keys.
  stream    the host-chunked probe stream (api._run_chunked), 1e7 build x
            1e8 probe in 4 chunks, count and materialize.
  ladder    exactness edge cases: key 2^64-1, an all-duplicate build and a
            duplicate run longer than a hash bucket chain.
  range     the partitioned tier's search, plain XLA vs the Pallas Triton
            kernel, at the 1e8 Q5 shape with sparse 64-bit keys.

--four-cards runs only the distributed tier over four GPUs (see
`four_cards`).  --scale N divides every size by N, and --cpu-rehearsal
lets the phases run on the CPU backend at such a size: that run prints no
result line.

Usage: python chip_smoke.py [--seed 0] [--four-cards]
The last stdout line is {"ok": true, "device": {...}} when every phase
passed; any failure exits nonzero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np


def log(*a):
    print(*a, flush=True)


class Smoke:
    """Phase runner: records failures, never swallows them silently."""

    def __init__(self, scale: int):
        self.scale = scale
        self.failed: list[str] = []

    def n(self, rows: int) -> int:
        return max(rows // self.scale, 1)

    def run(self, name, fn, *args):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn(self, *args)
        except Exception:  # noqa: BLE001 — reported and failed below
            traceback.print_exc()
            self.failed.append(name)
            log(f"== phase {name} FAILED")
        log(f"== phase {name} done in {time.perf_counter() - t0} s")


def peak_bytes() -> int:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def same_rows(keys, vals, want_keys, want_vals) -> bool:
    """(key, value) multiset equality; fast when both are in probe order."""
    if len(keys) != len(want_keys):
        return False
    if np.array_equal(keys, want_keys) and np.array_equal(vals, want_vals):
        return True
    a = np.lexsort((vals, keys))
    b = np.lexsort((want_vals, want_keys))
    return (np.array_equal(keys[a], want_keys[b])
            and np.array_equal(vals[a], want_vals[b]))


def check_join(label, bk, bv, pk, mode, strategy, *, want_count,
               want_rows=None, allow_merge=True):
    """One join through api._run_join, twice; exact check.

    Count runs the same call cold then warm, so their difference is the
    compile time.  Materialize runs cold with the result arrays (checked
    as rows), then warm with the run info (which strategy ran)."""
    from flash_hash_join_tpu import api

    calls, counts = [], []
    for want_info in (mode == "count", True):
        t0 = time.perf_counter()
        if want_info:
            count, core, info = api._run_join(
                bk, bv, pk, mode=mode, strategy=strategy, use_bloom=False,
                return_info=True)
        else:
            count, core, keys, vals = api._run_join(
                bk, bv, pk, mode=mode, strategy=strategy, use_bloom=False,
                return_arrays=True)
        calls.append((time.perf_counter() - t0, core))
        counts.append(count)
    ran = info["strategy"]
    ok = counts == [want_count, want_count]
    if mode != "count" and want_rows is not None:
        ok = ok and same_rows(keys, vals, *want_rows)
    log(f"{label} {mode} requested={strategy} ran={ran} "
        f"chunks={info['probe_chunks']} count={count} want={want_count} "
        f"exact={ok} first_call_s={calls[0][0]} warm_call_s={calls[1][0]} "
        f"run_s={calls[1][1]} peak_bytes_in_use={peak_bytes()}")
    if not ok:
        raise AssertionError(f"{label} {mode} {strategy}: result differs "
                             "from the oracle")
    if not allow_merge and ran == "merge":
        raise AssertionError(f"{label} {mode}: adaptive fell back to merge")
    return info, calls[1][1]


def memory_per_row(label, info):
    """Bytes per probe row of a compiled graph (argument, output, temp)."""
    compiled = info.get("compiled")
    if compiled is None:
        return
    ma = compiled.memory_analysis()
    nb, npr = info["nb"], info["npr"]
    log(f"{label} memory_analysis nb={nb} npr={npr} "
        f"argument_bytes={ma.argument_size_in_bytes} "
        f"output_bytes={ma.output_size_in_bytes} "
        f"temp_bytes={ma.temp_size_in_bytes} "
        f"temp_per_probe_row={ma.temp_size_in_bytes / npr} "
        f"temp_per_build_plus_probe_row={ma.temp_size_in_bytes / (nb + npr)}")


def oracle(bk, bv, pk, rows: bool):
    from flash_hash_join_tpu.utils import native
    count = native.host_join_count(bk, pk)
    return count, (native.host_join_materialize(bk, bv, pk) if rows else None)


def phase_j1(s: Smoke, seed: int):
    from flash_hash_join_tpu.models.workload import j1_suite
    from flash_hash_join_tpu import api

    for case in j1_suite(s.n(10**8), seed):
        bk, bv, pk = case.build_keys, case.build_values, case.probe_keys
        want, want_rows = oracle(bk, bv, pk, rows=True)
        info, t_direct = check_join(case.name, bk, bv, pk, "count",
                                    "adaptive", want_count=want,
                                    allow_merge=False)
        memory_per_row(f"{case.name} count {info['strategy']}", info)
        info, _ = check_join(case.name, bk, bv, pk, "materialize",
                             "adaptive", want_count=want,
                             want_rows=want_rows, allow_merge=False)
        memory_per_row(f"{case.name} materialize {info['strategy']}", info)
        info, t_part = check_join(case.name, bk, bv, pk, "count",
                                  "partitioned", want_count=want)
        memory_per_row(f"{case.name} count partitioned", info)
        _, _, info = api._run_join(bk, bv, pk, mode="materialize",
                                   strategy="partitioned", use_bloom=False,
                                   return_info=True)
        memory_per_row(f"{case.name} materialize partitioned", info)
        log(f"{case.name} rule: count adaptive_s={t_direct} "
            f"partitioned_s={t_part}")


def phase_api(s: Smoke, seed: int):
    import flash_hash_join_tpu as fj

    rng = np.random.default_rng(seed + 1)
    n = s.n(10**7)
    for width, hi in (("u64", 2**64 - 1), ("u32", 2**32 - 1)):
        bk = rng.integers(0, hi, n, dtype=np.uint64)
        bv = rng.integers(0, 2**63, n, dtype=np.uint64)
        pk = np.concatenate([rng.choice(bk, n - n // 10),
                             rng.integers(0, hi, n // 10, dtype=np.uint64)])
        rng.shuffle(pk)
        want, want_rows = oracle(bk, bv, pk, rows=True)
        for name in ("adaptive_join", "adaptive_join_bloom",
                     "adaptive_join_count", "adaptive_join_count_bloom",
                     "hash_join", "hash_join_bloom", "hash_join_radix",
                     "hash_join_radix_bloom", "hash_join_count",
                     "hash_join_count_bloom", "hash_join_count_radix",
                     "hash_join_count_radix_bloom"):
            t0 = time.perf_counter()
            count, core = getattr(fj, name)(bk, bv, pk)
            log(f"{width} {name} count={count} want={want} "
                f"call_s={time.perf_counter() - t0} core_s={core}")
            if count != want:
                raise AssertionError(f"{width} {name}: {count} != {want}")
        assert fj.initialize() is True
        for strategy in ("global", "partitioned", "merge"):
            check_join(width, bk, bv, pk, "count", strategy,
                       want_count=want)
            check_join(width, bk, bv, pk, "materialize", strategy,
                       want_count=want, want_rows=want_rows)
        # direct needs a dense domain: the same rows, keys folded into one
        dk = bk % np.uint64(int(n * 1.1))
        dp = pk % np.uint64(int(n * 1.1))
        dwant, dwant_rows = oracle(dk, bv, dp, rows=True)
        check_join(f"{width}-dense", dk, bv, dp, "count", "direct",
                   want_count=dwant)
        check_join(f"{width}-dense", dk, bv, dp, "materialize", "direct",
                   want_count=dwant, want_rows=dwant_rows)


def phase_stream(s: Smoke, seed: int):
    from flash_hash_join_tpu import api

    rng = np.random.default_rng(seed + 2)
    nb, npr = s.n(10**7), s.n(10**8)
    bk = rng.integers(0, 2**63, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, npr // 2),
                         rng.integers(0, 2**63, npr - npr // 2,
                                      dtype=np.uint64)])
    rng.shuffle(pk)
    want, want_rows = oracle(bk, bv, pk, rows=True)
    for mode in ("count", "materialize"):
        t0 = time.perf_counter()
        out = api._run_chunked(bk, bv, pk, mode=mode, strategy="partitioned",
                               use_bloom=False,
                               return_arrays=mode == "materialize",
                               return_info=False, probe_chunks=4)
        ok = out[0] == want
        if mode == "materialize":
            ok = ok and same_rows(out[2], out[3], *want_rows)
        log(f"stream {mode} chunks=4 count={out[0]} want={want} exact={ok} "
            f"call_s={time.perf_counter() - t0} stream_s={out[1]} "
            f"peak_bytes_in_use={peak_bytes()}")
        if not ok:
            raise AssertionError(f"stream {mode}: result differs")


def phase_ladder(s: Smoke, seed: int):
    rng = np.random.default_rng(seed + 3)
    n = s.n(10**6)
    top = np.uint64(2**64 - 1)
    bk = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    bk[::1000] = top
    bv = rng.integers(0, 2**63, n, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, n), np.full(n // 100, top)])
    cases = [("max-key", bk, bv, pk)]
    dup = np.full(n, 7, np.uint64)
    cases.append(("all-duplicate", dup, bv,
                  rng.integers(0, 9, n, dtype=np.uint64)))
    # one key repeated far past the global table's bucket chain bound
    run = rng.integers(0, 2**62, n, dtype=np.uint64)
    run[: n // 2] = np.uint64(12345)
    cases.append(("long-run", run, bv, np.concatenate(
        [run[n // 2:], np.full(n // 4, 12345, np.uint64)])))
    for label, k, v, p in cases:
        want, want_rows = oracle(k, v, p, rows=True)
        for strategy in ("adaptive", "global", "partitioned", "merge"):
            for mode in ("count", "materialize"):
                check_join(label, k, v, p, mode, strategy, want_count=want,
                           want_rows=want_rows)


def phase_range(s: Smoke, seed: int):
    """Plain XLA search vs the Pallas Triton kernel, same table, 1e8 Q5."""
    import jax
    import jax.numpy as jnp

    from flash_hash_join_tpu.ops import range_table as rt
    from flash_hash_join_tpu.ops.pallas import range_probe as rp
    from flash_hash_join_tpu.utils import u64

    rng = np.random.default_rng(seed + 4)
    n = s.n(10**8)
    bk = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, n - n // 10),
                         rng.integers(0, 2**64 - 1, n // 10,
                                      dtype=np.uint64)])
    want = oracle(bk, bk, pk, rows=False)[0]
    kh, kl = (jnp.asarray(a) for a in u64.split_u64(bk))
    ph, pl = (jnp.asarray(a) for a in u64.split_u64(pk))
    interpret = jax.devices()[0].platform == "cpu"

    def xla_search(t, p):
        return rt.search(t, p)

    def triton_search(t, p):
        return rp.search(t, p, interpret=interpret)

    def join_count(search, kh, kl, ph, pl):
        table = rt.build_range_table(kh, kl, kh, kl, kh.shape[0],
                                     with_values=False)
        found = search(table.keys, (ph, pl))
        return jnp.sum(found >= 0, dtype=jnp.int32)

    table = jax.jit(lambda a, b: rt.build_range_table(
        a, b, a, b, a.shape[0], with_values=False).keys)(kh, kl)
    results = {}
    for name, search in (("xla", xla_search), ("triton", triton_search)):
        f = jax.jit(search)
        t0 = time.perf_counter()
        found = f(table, (ph, pl)).block_until_ready()
        compile_s = time.perf_counter() - t0
        best = min(_timed(f, table, (ph, pl)) for _ in range(3))
        e2e = jax.jit(lambda *a, search=search: join_count(search, *a))
        count = int(e2e(kh, kl, ph, pl))
        best_e2e = min(_timed(e2e, kh, kl, ph, pl) for _ in range(3))
        results[name] = np.asarray(found)
        log(f"range search={name} n={n} count={count} want={want} "
            f"first_call_s={compile_s} search_s={best} "
            f"join_count_s={best_e2e} peak_bytes_in_use={peak_bytes()}")
        if count != want:
            raise AssertionError(f"range {name}: {count} != {want}")
    if not np.array_equal(results["xla"], results["triton"]):
        raise AssertionError("range: xla and triton positions differ")


def _timed(f, *args) -> float:
    t0 = time.perf_counter()
    out = f(*args)
    jax_block(out)
    return time.perf_counter() - t0


def jax_block(out):
    import jax
    jax.tree_util.tree_map(lambda x: x.block_until_ready(), out)


def four_cards(s: Smoke, seed: int):
    """Distributed tier over data_mesh(4): BASELINE config #5's shape (a
    uniform build, Zipf a=1.2 probes), cut from 1e9 x 1e9 to 1e8 x 1e8 for
    host memory and run time.  Checked against the host oracle and a
    one-card adaptive_join_count."""
    import flash_hash_join_tpu as fj
    from flash_hash_join_tpu.models.workload import zipf_probe_case

    case = zipf_probe_case(s.n(10**8), s.n(10**8), a=1.2, seed=seed)
    bk, bv, pk = case.build_keys, case.build_values, case.probe_keys
    want, want_rows = oracle(bk, bv, pk, rows=True)
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        count, core = fj.distributed_join_count(bk, bv, pk, n_devices=4)
        log(f"four-cards {label} distributed_join_count count={count} "
            f"want={want} call_s={time.perf_counter() - t0} core_s={core}")
        if count != want:
            raise AssertionError("distributed count differs")
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        count, core, keys, vals = fj.distributed_join_materialize(
            bk, bv, pk, n_devices=4, return_arrays=True)
        ok = count == want and same_rows(keys, vals, *want_rows)
        log(f"four-cards {label} distributed_join_materialize "
            f"count={count} want={want} exact={ok} "
            f"call_s={time.perf_counter() - t0} core_s={core}")
        if not ok:
            raise AssertionError("distributed materialize differs")
    one, core = fj.adaptive_join_count(bk, bv, pk)
    log(f"four-cards one-card adaptive_join_count count={one} core_s={core}")
    if one != want:
        raise AssertionError("one-card count differs")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed tier over 4 GPUs")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every size by this (rehearsals)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="allow the CPU backend; prints no result line")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu" and not args.cpu_rehearsal:
        print(f"chip_smoke: no GPU (JAX platform {platform!r})",
              file=sys.stderr)
        return 2
    import flash_hash_join_tpu as fj  # noqa: F401 — fails outside the repo

    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; devices={len(devs)} x {devs[0].device_kind}")
    s = Smoke(args.scale)
    if args.four_cards:
        if len(devs) < 4:
            print("chip_smoke: --four-cards needs 4 devices", file=sys.stderr)
            return 2
        s.run("four_cards", four_cards, args.seed)
    else:
        for name, phase in (("j1", phase_j1), ("api", phase_api),
                            ("stream", phase_stream),
                            ("ladder", phase_ladder),
                            ("range", phase_range)):
            s.run(name, phase, args.seed)
    if s.failed:
        print(f"chip_smoke: FAILED phases: {s.failed}", file=sys.stderr)
        return 1
    if platform != "gpu":
        log("chip_smoke: CPU rehearsal passed; no result on the CPU")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
