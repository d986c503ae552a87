"""Chunked probe streaming + feasibility model (models/cost.py).

The feasibility model must select chunking for probe sides whose
transient buffers exceed the device budget (read from memory_stats()),
and the host-chunked stream must stay exact — including max-key
sentinels, duplicates, and non-divisible sizes.
"""

import numpy as np
import pytest

from flash_hash_join_tpu.models import cost
from flash_hash_join_tpu.models.cost import (
    CPU_TEST_BUDGET_BYTES, choose_plan, plan_probe_chunks)
from flash_hash_join_tpu.utils.config import DEFAULT_CONFIG


def test_plan_single_shot_for_flagship():
    assert plan_probe_chunks(40_000_000, 40_000_000, "count") == 1
    assert plan_probe_chunks(100_000_000, 100_000_000, "count") == 1


def test_plan_chunks_baseline_config3():
    # BASELINE config #3: 10M build / 1e9 probes must stream in chunks
    n = plan_probe_chunks(10_000_000, 1_000_000_000, "count")
    assert n > 1
    # chunks stay coarse enough to amortize the per-chunk sorts
    assert n <= 16


def test_plan_respects_budget_knob():
    # a >HBM-probe plan selects chunking and scales with the budget
    tight = plan_probe_chunks(1_000_000, 50_000_000, "count",
                              budget_bytes=CPU_TEST_BUDGET_BYTES // 64)
    assert tight > plan_probe_chunks(1_000_000, 50_000_000, "count")


def test_choose_plan_carries_chunks():
    plan = choose_plan(10_000_000, 1_000_000_000, DEFAULT_CONFIG, "count")
    assert plan.strategy == "partitioned"
    assert plan.probe_chunks > 1


def _chunked(bk, pk, n_chunks, mode="count"):
    from flash_hash_join_tpu import api
    bv = np.arange(len(bk), dtype=np.uint64)
    return api._run_chunked(bk, bv, pk, mode=mode, strategy="partitioned",
                            use_bloom=False, return_arrays=mode != "count",
                            return_info=False, probe_chunks=n_chunks)


@pytest.mark.parametrize("nb,npr,n_chunks,narrow,seed", [
    (1000, 5000, 3, True, 0),
    (300, 4097, 4, True, 1),      # non-divisible, pad straddles chunks
    (20000, 60000, 3, False, 2),  # wide keys
    (1000, 3000, 2, True, 3),     # with max-key sentinels both sides
])
def test_chunked_count_exact(nb, npr, n_chunks, narrow, seed):
    rng = np.random.default_rng(seed)
    hi = 2**32 if narrow else 2**63
    bk = rng.integers(0, min(hi, nb * 2), nb, dtype=np.uint64)
    pk = rng.integers(0, min(hi, nb * 2), npr, dtype=np.uint64)
    if not narrow:
        bk = bk * np.uint64(2**33) + bk
        pk = pk * np.uint64(2**33) + pk
    if seed == 3:
        bk[5] = 2**32 - 1  # narrow max-key sentinel
        pk[7:20] = 2**32 - 1
    expected = int(np.isin(pk, bk).sum())
    count, _ = _chunked(bk, pk, n_chunks)
    assert count == expected


def test_chunked_matches_single_shot():
    import jax.numpy as jnp
    from flash_hash_join_tpu.ops import range_table as rt

    rng = np.random.default_rng(7)
    nb, npr = 5000, 20000
    kl = rng.integers(0, 8000, nb, dtype=np.uint32)
    pl = rng.integers(0, 8000, npr, dtype=np.uint32)
    z = jnp.zeros((nb,), jnp.uint32)
    zp = jnp.zeros((npr,), jnp.uint32)
    c1, s1 = rt.range_join_count(z, jnp.asarray(kl), z, z, zp,
                                 jnp.asarray(pl), nb, npr, narrow=True)
    c2, _ = _chunked(kl.astype(np.uint64), pl.astype(np.uint64), 5)
    c3, _, keys, _ = _chunked(kl.astype(np.uint64), pl.astype(np.uint64),
                              5, mode="materialize")
    assert int(s1[3]) == 0
    assert int(c1) == c2 == c3
    # chunks concatenate in probe order
    assert np.array_equal(keys, pl[np.isin(pl, kl)].astype(np.uint64))


def test_host_chunked_api_exact(monkeypatch):
    """api streams probe chunks host-side when the plan says >1 chunk:
    counts add up, materialize arrays concatenate, both exact."""
    import collections

    import flash_hash_join_tpu as fj
    from flash_hash_join_tpu.engine import JoinEngine
    from flash_hash_join_tpu.models.cost import JoinPlan

    def fake_plan(self, nb, npr, mode="count"):
        real = choose_plan(nb, npr, self.cfg, mode)
        return JoinPlan(real.strategy, real.gbits,
                        3 if npr >= 30_000 else 1)

    monkeypatch.setattr(JoinEngine, "plan", fake_plan)
    rng = np.random.default_rng(11)
    nb, npr = 4_000, 50_000
    bk = rng.integers(0, 6_000, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    pk = rng.integers(0, 6_000, npr, dtype=np.uint64)
    expected = int(np.isin(pk, np.unique(bk)).sum())

    count, core = fj.adaptive_join_count(bk, bv, pk)
    assert count == expected and core > 0

    c2, _, keys, vals = fj.join_materialize(bk, bv, pk, return_arrays=True)
    assert c2 == expected
    mask = np.isin(pk, np.unique(bk))
    assert collections.Counter(keys.tolist()) == collections.Counter(
        pk[mask].tolist())
    lut = {}
    for k, v in zip(bk.tolist(), bv.tolist()):
        lut.setdefault(k, set()).add(v)
    assert all(v in lut[k] for k, v in zip(keys.tolist(), vals.tolist()))


def test_host_chunked_serial_mode_matches(monkeypatch):
    """FHJ_CHUNK_OVERLAP=0 (per-chunk device timing) and the default
    depth-2 pipeline produce identical results."""
    import flash_hash_join_tpu as fj
    from flash_hash_join_tpu.engine import JoinEngine
    from flash_hash_join_tpu.models.cost import JoinPlan

    def fake_plan(self, nb, npr, mode="count"):
        real = choose_plan(nb, npr, self.cfg, mode)
        return JoinPlan(real.strategy, real.gbits,
                        3 if npr >= 30_000 else 1)

    monkeypatch.setattr(JoinEngine, "plan", fake_plan)
    rng = np.random.default_rng(17)
    nb, npr = 4_000, 50_000
    bk = rng.integers(0, 6_000, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    pk = rng.integers(0, 6_000, npr, dtype=np.uint64)
    expected = int(np.isin(pk, np.unique(bk)).sum())

    count, _ = fj.adaptive_join_count(bk, bv, pk)
    monkeypatch.setenv("FHJ_CHUNK_OVERLAP", "0")
    count_serial, core_serial = fj.adaptive_join_count(bk, bv, pk)
    assert count == count_serial == expected
    assert core_serial > 0


def test_chunked_oom_doubles_and_retries(monkeypatch):
    """A planned-feasible chunk that still ResourceExhausts must double the
    chunk count and retry, not propagate."""
    import flash_hash_join_tpu as fj
    from flash_hash_join_tpu.engine import JoinEngine
    from flash_hash_join_tpu.models.cost import JoinPlan

    def fake_plan(self, nb, npr, mode="count"):
        real = choose_plan(nb, npr, self.cfg, mode)
        return JoinPlan(real.strategy, real.gbits,
                        2 if npr >= 8_000 else 1)

    real_prepare = JoinEngine.prepare
    booms = []

    def fake_prepare(self, n_build, n_probe, mode, strategy, use_bloom,
                     **kw):
        compiled = real_prepare(self, n_build, n_probe, mode, strategy,
                                use_bloom, **kw)
        if n_probe > 3_000:  # "too big for the device" in this test
            def boom(*a):
                booms.append(n_probe)
                raise RuntimeError(
                    "RESOURCE_EXHAUSTED: Out of memory (synthetic)")
            return boom
        return compiled

    monkeypatch.setattr(JoinEngine, "plan", fake_plan)
    monkeypatch.setattr(JoinEngine, "prepare", fake_prepare)
    rng = np.random.default_rng(23)
    nb, npr = 1_000, 9_000
    bk = rng.integers(0, 2_000, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    pk = rng.integers(0, 2_000, npr, dtype=np.uint64)
    expected = int(np.isin(pk, np.unique(bk)).sum())

    count, _ = fj.adaptive_join_count(bk, bv, pk)
    assert count == expected
    # planned 2 chunks (4500 rows) boomed, 4 chunks (2250) succeeded
    assert booms and all(b > 3_000 for b in booms)


def test_single_shot_oom_falls_back_to_chunks(monkeypatch):
    """A planned-SINGLE-SHOT run that ResourceExhausts at execution time
    must fall back to host-side chunk streaming."""
    import flash_hash_join_tpu as fj
    from flash_hash_join_tpu.engine import JoinEngine

    real_prepare = JoinEngine.prepare
    booms = []

    def fake_prepare(self, n_build, n_probe, mode, strategy, use_bloom,
                     **kw):
        compiled = real_prepare(self, n_build, n_probe, mode, strategy,
                                use_bloom, **kw)
        if n_probe > 3_000:
            def boom(*a):
                booms.append(n_probe)
                raise RuntimeError(
                    "RESOURCE_EXHAUSTED: Out of memory (synthetic)")
            return boom
        return compiled

    monkeypatch.setattr(JoinEngine, "prepare", fake_prepare)
    rng = np.random.default_rng(29)
    nb, npr = 1_000, 10_000  # plans single-shot at this size
    # sparse keys (span ~2^31): the partitioned tier, not the dense domain
    bk = rng.integers(0, 2_000, nb, dtype=np.uint64) << np.uint64(20)
    bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    pk = rng.integers(0, 2_000, npr, dtype=np.uint64) << np.uint64(20)
    expected = int(np.isin(pk, np.unique(bk)).sum())

    count, _ = fj.adaptive_join_count(bk, bv, pk)
    assert count == expected
    assert booms  # the single-shot program did boom first


def test_plan_budgets_depth2_pipeline():
    """Chunked plans must reserve the pipelined next chunk's input planes:
    once chunking triggers, chunks are sized for per_row + 8 bytes."""
    nb, npr = 10_000_000, 1_000_000_000
    n = plan_probe_chunks(nb, npr, "count")
    fixed = cost.FIXED_BYTES_PER_BUILD_ROW * nb
    avail = CPU_TEST_BUDGET_BYTES - fixed
    # per_row + pipelined input planes
    chunk_rows = avail // (8 + cost.TRANSIENT_BYTES_COUNT + 8)
    assert n == -(-npr // chunk_rows)


def test_plan_raises_on_oversized_build():
    with pytest.raises(MemoryError):
        plan_probe_chunks(10**9, 10**6, "count")


def test_rechunked_padded_tail_not_counted(monkeypatch):
    """A padded caller (the chunk stream's overflow retry) passes
    _valid_probe_rows; if the plan then says to re-chunk, the pad tail
    must be trimmed first — pad keys are 0, which can be a REAL build key,
    and the chunk stream has no validity parameter (fuzzer --chunked
    catch, round 4: tiny-universe all-zero build keys overcounted +13
    through the recursive re-chunk cascade)."""
    import flash_hash_join_tpu.api as api
    from flash_hash_join_tpu.engine import JoinEngine
    from flash_hash_join_tpu.models.cost import JoinPlan

    def fake_plan(self, nb, npr, mode="count"):
        real = choose_plan(nb, npr, self.cfg, mode)
        return JoinPlan(real.strategy, real.gbits,
                        2 if npr >= 4_000 else 1)

    monkeypatch.setattr(JoinEngine, "plan", fake_plan)
    rng = np.random.default_rng(991)
    nb = 1_000
    bk = np.zeros(nb, dtype=np.uint64)          # 0 is a real build key
    bv = rng.integers(0, 2**31, nb, dtype=np.uint64)
    valid = 7_990
    pk = rng.integers(0, 3, valid, dtype=np.uint64)
    padded = np.pad(pk, (0, 10))                # 10 pad rows of key 0
    expected = int((pk == 0).sum())

    count, _ = api._run_join(bk, bv, padded, mode="count",
                             strategy="partitioned", use_bloom=False,
                             _valid_probe_rows=valid)
    assert count == expected


def test_explicit_strategies_bypass_partitioned_plan(monkeypatch):
    """merge/global requests must not consult (or trip) the
    partitioned feasibility plan."""
    import flash_hash_join_tpu as fj
    from flash_hash_join_tpu.engine import JoinEngine

    def exploding_plan(self, nb, npr, mode="count"):
        raise AssertionError("plan() must not be called")

    monkeypatch.setattr(JoinEngine, "plan", exploding_plan)
    rng = np.random.default_rng(2)
    bk = rng.integers(0, 3_000, 2_000, dtype=np.uint64)
    bv = rng.integers(0, 2**63, 2_000, dtype=np.uint64)
    pk = rng.integers(0, 3_000, 5_000, dtype=np.uint64)
    want = int(np.isin(pk, np.unique(bk)).sum())
    c, _ = fj.join_count(bk, bv, pk, strategy="merge")
    assert c == want
    c, _ = fj.join_count(bk, bv, pk, strategy="global")
    assert c == want


def test_chunked_dense_key_count_routes_direct(monkeypatch):
    """A chunked probe stream over
    a dense build domain routes each chunk through the direct bitmap
    strategy — counts stay exact and info reports the direct route."""
    import flash_hash_join_tpu.api as api
    from flash_hash_join_tpu.engine import JoinEngine
    from flash_hash_join_tpu.models.cost import JoinPlan

    def fake_plan(self, nb, npr, mode="count"):
        real = choose_plan(nb, npr, self.cfg, mode)
        return JoinPlan(real.strategy, real.gbits,
                        3 if npr >= 150_000 else 1)

    monkeypatch.setattr(JoinEngine, "plan", fake_plan)
    rng = np.random.default_rng(55)
    nb, npr = 30_000, 240_000           # per-chunk 80_000 >= 2^16 gate
    bk = rng.integers(0, int(nb * 1.1), nb, dtype=np.uint64)
    bv = rng.integers(0, 2**31, nb, dtype=np.uint64)
    pk = rng.integers(0, int(nb * 1.3), npr, dtype=np.uint64)
    expected = int(np.isin(pk, np.unique(bk)).sum())

    count, _, info = api._run_join(bk, bv, pk, mode="count",
                                   strategy="adaptive", use_bloom=False,
                                   return_info=True)
    assert count == expected
    assert info["probe_chunks"] == 3
    assert info["strategy"] == "direct"
    assert info["d_rows"] > 0


def test_chunked_materialize_keeps_sort_route(monkeypatch):
    """Chunked materialize must NOT take the dense upgrade (value planes
    would rebuild per chunk; unmeasured) — and must stay exact."""
    import flash_hash_join_tpu.api as api
    from flash_hash_join_tpu.engine import JoinEngine
    from flash_hash_join_tpu.models.cost import JoinPlan

    def fake_plan(self, nb, npr, mode="count"):
        real = choose_plan(nb, npr, self.cfg, mode)
        return JoinPlan(real.strategy, real.gbits,
                        3 if npr >= 150_000 else 1)

    monkeypatch.setattr(JoinEngine, "plan", fake_plan)
    rng = np.random.default_rng(56)
    nb, npr = 30_000, 240_000
    bk = rng.integers(0, int(nb * 1.1), nb, dtype=np.uint64)
    bv = rng.integers(0, 2**31, nb, dtype=np.uint64)
    pk = rng.integers(0, int(nb * 1.3), npr, dtype=np.uint64)
    expected = int(np.isin(pk, np.unique(bk)).sum())

    count, _, info = api._run_join(bk, bv, pk, mode="materialize",
                                   strategy="adaptive", use_bloom=False,
                                   return_info=True)
    assert count == expected
    assert info["strategy"] != "direct"


class _Dev:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("platform,stats,want", [
    ("gpu", {"bytes_limit": 60 * 2**30, "peak_bytes_in_use": 1},
     int(60 * 2**30 * (1 - cost.HEADROOM_FRACTION))),
    ("cpu", None, CPU_TEST_BUDGET_BYTES),
    ("cpu", {}, CPU_TEST_BUDGET_BYTES),
])
def test_budget_from_memory_stats(monkeypatch, platform, stats, want):
    """The budget is the device's bytes_limit less the headroom; only the
    CPU backend, which reports no statistics, falls back to a constant."""
    import jax
    monkeypatch.setattr(jax, "devices", lambda: [_Dev(platform, stats)])
    assert cost.device_budget_bytes() == want


def test_budget_without_stats_fails_on_a_device(monkeypatch):
    import jax
    monkeypatch.setattr(jax, "devices", lambda: [_Dev("gpu", {})])
    with pytest.raises(RuntimeError):
        cost.device_budget_bytes()


def test_plan_uses_device_budget(monkeypatch):
    """plan_probe_chunks without an explicit budget reads the device."""
    import jax
    small = {"bytes_limit": 2**30}
    monkeypatch.setattr(jax, "devices", lambda: [_Dev("gpu", small)])
    assert plan_probe_chunks(1_000_000, 100_000_000, "count") == \
        plan_probe_chunks(1_000_000, 100_000_000, "count",
                          budget_bytes=int(2**30 * 0.8))
    assert plan_probe_chunks(1_000_000, 100_000_000, "count") > 1
