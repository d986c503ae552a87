"""Public API: the reference pybind module's 13 functions, on a JAX device.

Mirrors `PYBIND11_MODULE(flash_join, m)` (hash_join.cpp:598-640): every join
function takes numpy uint64 arrays (build_keys, build_values, probe_keys) and
returns `(count, core_seconds)` where core_seconds is device execution time
excluding host<->device transfer and compilation (the reference's SimpleTimer
likewise starts after pybind buffer marshaling, hash_join.cpp:385-390).

Name mapping (reference -> here, identical names):
  adaptive_join / adaptive_join_bloom / adaptive_join_count /
  adaptive_join_count_bloom           — cost-model strategy selection
  hash_join / hash_join_bloom          — single global table ("scalar" path)
  hash_join_radix / hash_join_radix_bloom — partitioned path
  hash_join_count[_bloom|_radix|_radix_bloom] — count-only variants
  initialize                           — warm up the backend

Extended (beyond the reference, which fills and drops its outputs,
hash_join.cpp:444,:494): `join_materialize(..., return_arrays=True)` also
returns the materialized (probe_key, value) numpy arrays.

Output-order contract: the ROW MULTISET is identical across strategies
(asserted by benchmark.py's value-parity harness); the ORDER is
strategy-specific but deterministic — global, partitioned and direct emit
probe order, merge emits (hash, key) order.  The reference's own order is
thread-interleaved and nondeterministic (SURVEY.md §3), so any fixed order
satisfies parity.  Dedup winner on duplicate build keys: the first input
occurrence, in every strategy (the C++ oracle's rule too); the
reference's own winner is a data race (hash_join.cpp:147).
"""

from __future__ import annotations

import time

import jax
import numpy as np

from flash_hash_join_tpu.engine import default_engine
from flash_hash_join_tpu.utils import u64

import contextlib
import os


def _maybe_profile():
    """jax.profiler trace around the timed device call when
    FHJ_PROFILE_DIR is set (SURVEY §5 tracing tier: the reference only has
    SimpleTimer; we add optional XLA-level traces on top of the same
    core-seconds contract)."""
    trace_dir = os.environ.get("FHJ_PROFILE_DIR")
    if not trace_dir:
        return contextlib.nullcontext()
    import jax.profiler
    return jax.profiler.trace(trace_dir)


def _as_u64(arr) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != np.uint64:
        arr = arr.astype(np.uint64)
    return arr


def _run_join(build_keys, build_values, probe_keys, *, mode: str,
              strategy: str, use_bloom: bool, return_arrays: bool = False,
              return_info: bool = False, _valid_probe_rows: int | None = None):
    build_keys = _as_u64(build_keys)
    build_values = _as_u64(build_values)
    probe_keys = _as_u64(probe_keys)
    if build_keys.shape != build_values.shape:
        raise ValueError("build_keys and build_values must have equal length")
    nb, npr = build_keys.shape[0], probe_keys.shape[0]

    if nb == 0 or npr == 0:
        empty = np.zeros((0,), np.uint64)
        if return_info:
            return 0, 0.0, None
        if return_arrays:
            return 0, 0.0, empty, empty
        return 0, 0.0

    eng = default_engine()
    requested = strategy
    # The feasibility plan sizes probe chunks for the partitioned tier;
    # explicitly requested merge/global strategies bypass it (their graphs
    # have different footprints and must not fail on its accounting).
    if strategy == "adaptive":
        plan = eng.plan(nb, npr, mode)
        strategy = plan.strategy
        probe_chunks = plan.probe_chunks
    elif strategy in ("partitioned", "direct"):
        probe_chunks = eng.plan(nb, npr, mode).probe_chunks
    elif strategy in ("global", "merge"):
        probe_chunks = 1
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    # Dense-domain upgrade: db-benchmark J1 build keys are dense ints, so
    # membership counting needs a BITMAP, not a hash table, and value
    # fetch a direct-address row plane, not a probe (ops/direct_bitmap.py —
    # DuckDB's perfect-hash-join statistic).  Detected host-side from the
    # numpy inputs, outside core_seconds, like the narrow-key check below.
    # Only the adaptive entry upgrades — explicitly named strategies must
    # run what was asked (benchmark.py compares them as distinct
    # implementations).  Chunked materialize keeps the partitioned route
    # (the row plane would rebuild per chunk).
    d_rows = 0
    if requested in ("adaptive", "direct") and not (
            mode == "materialize" and probe_chunks > 1):
        from flash_hash_join_tpu.ops import direct_bitmap as db
        bk_max = int(build_keys.max())
        span = bk_max - int(build_keys.min()) + 1
        # chunked streams decide on the PER-CHUNK probe count: that is the
        # graph each chunk runs, and the domain is rebuilt per chunk
        npr_gate = -(-npr // probe_chunks)
        if bk_max < 2**32 and (
                db.dense_domain_ok(span, nb, npr_gate)
                or (requested == "direct" and span <= db.MAX_DOMAIN_SLOTS)):
            strategy = "direct"
            d_rows = (db.d_rows_for(span) if mode == "count"
                      else db.v_rows_for(span))
    if requested == "direct" and d_rows == 0:
        raise ValueError(
            "direct strategy requires build keys < 2^32 spanning at most "
            f"2^30 slots (got nb={nb})")
    if probe_chunks > 1:
        # A padded caller (the chunk stream's overflow retry) marks its pad
        # tail via _valid_probe_rows; the chunk stream has no validity
        # parameter, so TRIM to the valid prefix before re-chunking — pad
        # keys are arbitrary (often 0) and would otherwise count as real
        # probe rows (fuzzer --chunked catch, round 4).
        if _valid_probe_rows is not None:
            probe_keys = probe_keys[:_valid_probe_rows]
        return _run_chunked(build_keys, build_values, probe_keys, mode=mode,
                            strategy=strategy, use_bloom=use_bloom,
                            return_arrays=return_arrays,
                            return_info=return_info,
                            probe_chunks=probe_chunks, d_rows=d_rows)

    # Type-specialized codegen (the standard DB move), checked host-side,
    # outside core_seconds — like the reference's pybind marshaling, which
    # its SimpleTimer also excludes: 32-bit keys run the partitioned tier
    # on one key word, 32-bit values drop the value-hi plane.
    narrow, narrow_values = _narrow_flags(build_keys, build_values,
                                          probe_keys, mode, strategy)
    compiled = eng.prepare(nb, npr, mode, strategy, use_bloom, narrow=narrow,
                           narrow_values=narrow_values, d_rows=d_rows)

    kh, kl = u64.split_u64(build_keys)
    vh, vl = u64.split_u64(build_values)
    ph, pl = u64.split_u64(probe_keys)
    args = [jax.device_put(a) for a in (kh, kl, vh, vl, ph, pl)]
    np_valid = npr if _valid_probe_rows is None else _valid_probe_rows
    args += [jax.device_put(np.int32(nb)), jax.device_put(np.int32(np_valid))]
    for a in args:
        a.block_until_ready()

    # Timing barrier: block on the SCALAR count output.  All outputs come
    # from one XLA program, so the scalar is ready exactly when the program
    # finishes — the analog of the reference's SimpleTimer stop
    # (hash_join.cpp:45-55 — excludes marshaling, includes compute).
    with _maybe_profile():
        try:
            t0 = time.perf_counter()
            out = compiled(*args)
            out[0].block_until_ready()
            core_seconds = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — filtered to OOM below
            # A planned-single-shot run that still ResourceExhausts (the
            # feasibility constants are measured, not guaranteed) falls
            # back to host-side chunk streaming instead of propagating.
            if not _is_oom(e) or strategy != "partitioned" \
                    or _valid_probe_rows is not None:
                raise
            args = None  # free the device buffers before the retry
            return _run_chunked(build_keys, build_values, probe_keys,
                                mode=mode, strategy=strategy,
                                use_bloom=use_bloom,
                                return_arrays=return_arrays,
                                return_info=return_info, probe_chunks=2)

    # All graphs return (..., special4); special[3] != 0 means the strategy
    # dropped keys (bucket overflow, out-of-domain rows on adversarial
    # inputs) — rerun on the always-exact merge tier so results never
    # degrade.
    if int(np.asarray(out[-1])[3]) != 0 and strategy != "merge":
        strategy = "merge"
        compiled = eng.prepare(nb, npr, mode, strategy, use_bloom,
                               narrow_values=narrow_values)
        t0 = time.perf_counter()
        out = compiled(*args)
        out[0].block_until_ready()
        core_seconds = time.perf_counter() - t0

    if return_info:
        return int(out[0]), core_seconds, dict(
            strategy=strategy, narrow=narrow,
            narrow_values=narrow_values, probe_chunks=1,
            use_bloom=use_bloom, compiled=compiled, args=args,
            nb=nb, npr=npr, d_rows=d_rows if strategy == "direct" else 0)
    if mode == "count":
        return int(out[0]), core_seconds
    count = int(out[0])
    if return_arrays:
        out_keys = u64.join_u64(np.asarray(out[1]), np.asarray(out[2]))[:count]
        out_vals = u64.join_u64(np.asarray(out[3]), np.asarray(out[4]))[:count]
        return count, core_seconds, out_keys, out_vals
    return count, core_seconds


def _narrow_flags(build_keys, build_values, probe_keys, mode: str,
                  strategy: str) -> tuple[bool, bool]:
    """(narrow keys, narrow values) for the graph about to compile."""
    narrow = (strategy == "partitioned" and int(build_keys.max()) < 2**32
              and int(probe_keys.max()) < 2**32)
    narrow_values = (mode == "materialize"
                     and strategy in ("partitioned", "direct")
                     and int(build_values.max()) < 2**32)
    return narrow, narrow_values


def _is_oom(e: Exception) -> bool:
    return "RESOURCE_EXHAUSTED" in str(e) or "Resource exhausted" in str(e)


def _run_chunked(build_keys, build_values, probe_keys, *, mode: str,
                 strategy: str, use_bloom: bool, return_arrays: bool,
                 return_info: bool, probe_chunks: int, d_rows: int = 0):
    """Host-side probe-chunk streaming with transfer/compute OVERLAP.

    The feasibility model (models/cost.py plan_probe_chunks) said the probe
    side exceeds the device budget in one shot: stream chunks from the host —
    the reference's morsel loop writ large (hash_join.cpp:302,:347).  Counts
    are additive over probe chunks; materialize outputs concatenate
    (first-match semantics are per-probe-row).  The last slice is PADDED to
    the uniform chunk length (true valid count passed through) so every
    chunk reuses ONE compiled program.

    Depth-2 pipeline: chunk k+1's host slice/pad + H2D transfer + dispatch
    are issued BEFORE blocking on chunk k's scalar, so the transfer rides
    under chunk k's compute (at most two chunks device-resident, which
    plan_probe_chunks budgets for).  FHJ_CHUNK_OVERLAP=0 restores the
    serial loop, whose summed per-chunk blocking times are the "summed
    device time" comparison point (scripts/run_config3.py prints both).

    Feasibility constants are calibrated, not guaranteed: if a
    planned-feasible chunk still ResourceExhausts, the chunk count doubles
    and the stream retries (mirror of the grown-quota exactness retry).
    """
    overlap = os.environ.get("FHJ_CHUNK_OVERLAP", "1") != "0"
    while True:
        try:
            return _stream_chunks(
                build_keys, build_values, probe_keys, mode=mode,
                strategy=strategy, use_bloom=use_bloom,
                return_arrays=return_arrays, return_info=return_info,
                probe_chunks=probe_chunks, overlap=overlap, d_rows=d_rows)
        except Exception as e:  # noqa: BLE001 — filtered to OOM below
            if not _is_oom(e) or probe_chunks >= 65536:
                raise
            probe_chunks *= 2


def _stream_chunks(build_keys, build_values, probe_keys, *, mode: str,
                   strategy: str, use_bloom: bool, return_arrays: bool,
                   return_info: bool, probe_chunks: int, overlap: bool,
                   d_rows: int = 0):
    eng = default_engine()
    nb, npr = len(build_keys), len(probe_keys)
    chunk = -(-npr // probe_chunks)
    # Narrow decisions from the GLOBAL key maxes (not per-chunk) so every
    # chunk shares one compiled program.
    narrow, narrow_values = _narrow_flags(build_keys, build_values,
                                          probe_keys, mode, strategy)
    compiled = eng.prepare(nb, chunk, mode, strategy, use_bloom,
                           narrow=narrow, narrow_values=narrow_values,
                           d_rows=d_rows)
    kh, kl = u64.split_u64(build_keys)
    vh, vl = u64.split_u64(build_values)
    bargs = [jax.device_put(a) for a in (kh, kl, vh, vl)]
    nb_dev = jax.device_put(np.int32(nb))
    for a in bargs:
        a.block_until_ready()

    def issue(i):
        sl = probe_keys[i:i + chunk]
        valid = len(sl)
        if valid < chunk:
            sl = np.pad(sl, (0, chunk - valid))
        ph, pl = u64.split_u64(sl)
        args = bargs + [jax.device_put(ph), jax.device_put(pl), nb_dev,
                        jax.device_put(np.int32(valid))]
        if not overlap:
            for a in args:
                a.block_until_ready()
            t0 = time.perf_counter()
            out = compiled(*args)
            out[0].block_until_ready()
            return out, valid, i, time.perf_counter() - t0
        return compiled(*args), valid, i, 0.0

    total, core = 0, 0.0
    arrs = ([], []) if (return_arrays and mode == "materialize") else None

    def drain(pending):
        nonlocal total, core
        out, valid, i, dt = pending
        out[0].block_until_ready()
        if int(np.asarray(out[-1])[3]) != 0:
            # strategy overflow on this chunk: serial retry ladder,
            # rare by construction (adversarial key distributions)
            sl = probe_keys[i:i + chunk]
            v = len(sl)
            if v < chunk:
                sl = np.pad(sl, (0, chunk - v))
            # direct overflow (unresolved window) is deterministic on the
            # same inputs — go straight to the always-exact merge tier
            retry = "merge" if strategy == "direct" else strategy
            res = _run_join(build_keys, build_values, sl, mode=mode,
                            strategy=retry, use_bloom=use_bloom,
                            return_arrays=arrs is not None,
                            _valid_probe_rows=v)
            total += res[0]
            core += res[1]
            if arrs is not None:
                arrs[0].append(res[2])
                arrs[1].append(res[3])
            return
        total += int(out[0])
        core += dt
        if arrs is not None:
            c = int(out[0])
            arrs[0].append(
                u64.join_u64(np.asarray(out[1]), np.asarray(out[2]))[:c])
            arrs[1].append(
                u64.join_u64(np.asarray(out[3]), np.asarray(out[4]))[:c])

    t_wall0 = time.perf_counter()
    pending = issue(0)
    for nxt in range(chunk, npr, chunk):
        nxt_pending = issue(nxt)  # overlap: in flight while we drain k
        drain(pending)
        pending = nxt_pending
    drain(pending)
    if overlap:
        # Per-chunk device deltas don't exist under pipelining; the honest
        # number is the wall time of the dispatch+drain loop (includes the
        # overlapped H2D transfers — they are intrinsic to streaming).
        core = time.perf_counter() - t_wall0

    if return_info:
        return total, core, dict(strategy=strategy, narrow=narrow,
                                 narrow_values=narrow_values,
                                 use_bloom=use_bloom, compiled=None,
                                 args=None, nb=nb, npr=npr,
                                 probe_chunks=probe_chunks,
                                 d_rows=d_rows if strategy == "direct" else 0)
    if arrs is not None:
        return total, core, np.concatenate(arrs[0]), np.concatenate(arrs[1])
    return total, core


# --- reference-parity API (13 functions, hash_join.cpp:603-639) -------------

def adaptive_join(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="materialize", strategy="adaptive", use_bloom=False)


def adaptive_join_bloom(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="materialize", strategy="adaptive", use_bloom=True)


def adaptive_join_count(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="count", strategy="adaptive", use_bloom=False)


def adaptive_join_count_bloom(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="count", strategy="adaptive", use_bloom=True)


def hash_join(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="materialize", strategy="global", use_bloom=False)


def hash_join_bloom(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="materialize", strategy="global", use_bloom=True)


def hash_join_radix(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="materialize", strategy="partitioned", use_bloom=False)


def hash_join_radix_bloom(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="materialize", strategy="partitioned", use_bloom=True)


def hash_join_count(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="count", strategy="global", use_bloom=False)


def hash_join_count_bloom(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="count", strategy="global", use_bloom=True)


def hash_join_count_radix(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="count", strategy="partitioned", use_bloom=False)


def hash_join_count_radix_bloom(build_keys, build_values, probe_keys):
    return _run_join(build_keys, build_values, probe_keys,
                     mode="count", strategy="partitioned", use_bloom=True)


def initialize():
    """Warm up the JAX backend (reference: initialize_memory_system pins
    mimalloc at import, hash_join.cpp:596-599; here we just touch the device
    so first-call latency is paid up front)."""
    jax.device_put(np.zeros((1,), np.uint32)).block_until_ready()
    return True


# --- extended API ------------------------------------------------------------

def plan_strategy(n_build: int, n_probe: int, mode: str = "count") -> str:
    """The strategy the adaptive dispatcher plans for this shape before
    the data-dependent dense-domain upgrade (models/cost.py); lets
    harnesses detect when `_bloom` variants alias their plain twin (bloom
    only changes the executed graph on the 'global' strategy)."""
    try:
        return default_engine().plan(n_build, n_probe, mode).strategy
    except MemoryError:
        # plan() raises when even the BUILD side exceeds the budget;
        # the strategy answer is shape-independent of that feasibility
        # check, and this is a pure introspection helper — never raise.
        return "partitioned"


def bloom_is_distinct(n_build: int, n_probe: int, mode: str = "count",
                      strategy: str = "adaptive") -> bool:
    """True when use_bloom=True compiles a different graph than
    use_bloom=False for this (shape, strategy)."""
    if strategy == "adaptive":
        strategy = plan_strategy(n_build, n_probe, mode)
    return strategy == "global"


def measure_device_seconds(build_keys, build_values, probe_keys, *,
                           mode: str = "count", strategy: str = "adaptive",
                           use_bloom: bool = False, reps: int | None = None,
                           number: int = 3):
    """Steady-state per-join DEVICE seconds via the chained-delta method.

    Runs the join once through the normal API (resolving the adaptive plan
    and any exactness retries), then compiles the same graph chained
    `reps` times inside one scan on key-remixed inputs (engine.py
    `_compiled_chained`) and reports

        (t_chained - t_single) / (reps - 1)

    which cancels the flat per-call cost (dispatch, argument handling,
    result fetch) that the reference's in-process SimpleTimer never sees
    (hash_join.cpp:45-55 starts after pybind marshaling), leaving the
    device's own time per join.  The remix is a key-space bijection
    applied to both sides, so every chained step's count equals the real
    count; this is asserted, and on any mismatch (or strategy overflow on
    a remixed step) the single-call time is returned with chained=False.

    Returns (count, device_seconds, single_call_seconds, chained: bool).
    """
    count, single, info = _run_join(
        build_keys, build_values, probe_keys, mode=mode, strategy=strategy,
        use_bloom=use_bloom, return_info=True)
    if info is None:  # empty input
        return count, single, single, False
    if reps is None:
        # Size the chain so the timed DELTA (~0.3 s) clears host-clock
        # jitter; the single-call time bounds the per-join device time.
        reps = int(min(48, max(4, 1 + 0.3 / max(single, 0.002))))
    # big counts would overflow the int32 invariance accumulator; huge
    # probe sides (chunked plans) dwarf the per-call cost anyway
    if count * reps >= 2**31:
        reps = (2**31 - 1) // max(count, 1)
    if info["probe_chunks"] > 1 or reps < 2:
        return count, single, single, False

    eng = default_engine()
    chained = eng.prepare_chained(
        info["nb"], info["npr"], mode, info["strategy"], info["use_bloom"],
        reps, narrow=info["narrow"], narrow_values=info["narrow_values"],
        d_rows=info["d_rows"])
    plain, args = info["compiled"], info["args"]

    def best(fn, block_all):
        b = float("inf")
        for _ in range(number):
            t0 = time.perf_counter()
            out = fn(*args)
            if block_all:
                for o in out:
                    o.block_until_ready()
            else:
                out[0].block_until_ready()
            b = min(b, time.perf_counter() - t0)
        return b, out

    _warm = chained(*args)  # compile/warm outside the timed runs
    c_sum, s_sum = int(_warm[0]), int(_warm[1])
    if c_sum != reps * count or s_sum != 0:
        return count, single, single, False
    t_chain, _ = best(chained, True)
    t_single, _ = best(plain, False)
    dev = (t_chain - t_single) / (reps - 1)
    if dev <= 0:  # noise swamped the delta (tiny join); report single-call
        return count, min(single, t_single), min(single, t_single), False
    return count, dev, min(single, t_single), True

def distributed_join_count(build_keys, build_values, probe_keys, *,
                           n_devices: int | None = None,
                           use_bloom: bool = False):
    """Exact distributed count join over a device mesh (extended API).

    NOT PRESENT in the reference (single-node CPU); this is the SURVEY §5
    distributed tier: hash shuffle over `jax.lax.all_to_all`, sampled
    heavy-hitter replication for Zipf skew, grown-quota retry until the
    overflow counter is zero.  n_devices defaults to the largest power of
    two available.  Returns (count, core_seconds).
    """
    import time as _time

    from flash_hash_join_tpu.parallel.mesh import data_mesh
    from flash_hash_join_tpu.parallel.distributed_join import (
        distributed_join_exact,
    )
    from flash_hash_join_tpu.utils import u64 as _u64

    build_keys = _as_u64(build_keys)
    build_values = _as_u64(build_values)
    probe_keys = _as_u64(probe_keys)
    if build_keys.shape != build_values.shape:
        raise ValueError("build_keys and build_values must have equal length")
    if len(build_keys) == 0 or len(probe_keys) == 0:
        return 0, 0.0
    if n_devices is None:
        n = len(jax.devices())
        n_devices = 1 << (n.bit_length() - 1)  # largest power of two <= n
    mesh = data_mesh(n_devices)
    kh, kl = _u64.split_u64(build_keys)
    vh, vl = _u64.split_u64(build_values)
    ph, pl = _u64.split_u64(probe_keys)
    t0 = _time.perf_counter()
    count = distributed_join_exact(mesh, kh, kl, vh, vl, ph, pl,
                                   use_bloom=use_bloom)
    return count, _time.perf_counter() - t0


def distributed_join_materialize(build_keys, build_values, probe_keys, *,
                                 n_devices: int | None = None,
                                 use_bloom: bool = False,
                                 return_arrays: bool = False):
    """Exact distributed materialize join over a device mesh (extended API).

    Same shuffle/hot-key/grown-quota machinery as distributed_join_count;
    materialized (probe_key, build_value) rows are compacted per shard and
    assembled host-side in shard order (deterministic).  Returns
    (count, core_seconds) or, with return_arrays, (count, core_seconds,
    out_keys, out_values) as uint64 numpy arrays.
    """
    import time as _time

    from flash_hash_join_tpu.parallel.mesh import data_mesh
    from flash_hash_join_tpu.parallel.distributed_join import (
        distributed_join_exact,
    )
    from flash_hash_join_tpu.utils import u64 as _u64

    build_keys = _as_u64(build_keys)
    build_values = _as_u64(build_values)
    probe_keys = _as_u64(probe_keys)
    if build_keys.shape != build_values.shape:
        raise ValueError("build_keys and build_values must have equal length")
    if len(build_keys) == 0 or len(probe_keys) == 0:
        empty = np.zeros((0,), np.uint64)
        return (0, 0.0, empty, empty) if return_arrays else (0, 0.0)
    if n_devices is None:
        n = len(jax.devices())
        n_devices = 1 << (n.bit_length() - 1)
    mesh = data_mesh(n_devices)
    kh, kl = _u64.split_u64(build_keys)
    vh, vl = _u64.split_u64(build_values)
    ph, pl = _u64.split_u64(probe_keys)
    t0 = _time.perf_counter()
    count, okh, okl, ovh, ovl = distributed_join_exact(
        mesh, kh, kl, vh, vl, ph, pl, use_bloom=use_bloom,
        materialize=True)
    core = _time.perf_counter() - t0
    if not return_arrays:
        return count, core
    return (count, core, _u64.join_u64(okh, okl), _u64.join_u64(ovh, ovl))


def join_count(build_keys, build_values, probe_keys, *, strategy="adaptive",
               use_bloom=False):
    return _run_join(build_keys, build_values, probe_keys, mode="count",
                     strategy=strategy, use_bloom=use_bloom)


def join_materialize(build_keys, build_values, probe_keys, *,
                     strategy="adaptive", use_bloom=False,
                     return_arrays=False):
    return _run_join(build_keys, build_values, probe_keys, mode="materialize",
                     strategy=strategy, use_bloom=use_bloom,
                     return_arrays=return_arrays)
