"""Public API contract: all 13 reference functions, strategy selection,
overflow fallback, extended materialize arrays."""

import numpy as np
import pytest

import flash_hash_join_tpu as fj
from flash_hash_join_tpu.models.cost import choose_plan
from flash_hash_join_tpu.utils.config import DEFAULT_CONFIG
from tests.oracle import oracle_count

ALL_FNS = [
    "adaptive_join", "adaptive_join_bloom", "adaptive_join_count",
    "adaptive_join_count_bloom", "hash_join", "hash_join_bloom",
    "hash_join_radix", "hash_join_radix_bloom", "hash_join_count",
    "hash_join_count_bloom", "hash_join_count_radix",
    "hash_join_count_radix_bloom",
]


def test_initialize():
    assert fj.initialize() is True


def test_all_reference_functions_agree():
    rng = np.random.default_rng(0)
    bk = rng.integers(0, 20_000, 10_000, dtype=np.uint64)
    bv = rng.integers(0, 2**63, 10_000, dtype=np.uint64)
    pk = rng.integers(0, 20_000, 30_000, dtype=np.uint64)
    expected = oracle_count(bk, pk)
    for name in ALL_FNS:
        count, secs = getattr(fj, name)(bk, bv, pk)
        assert count == expected, name
        assert secs >= 0.0


def test_vmem_strategy_raises():
    """The removed vmem tier is an unknown strategy now: ValueError, at
    the API and at the engine, and the adaptive plan never names it."""
    from flash_hash_join_tpu import engine
    assert choose_plan(30_000, 200_000, DEFAULT_CONFIG).strategy == (
        "partitioned")
    bk = np.arange(10, dtype=np.uint64)
    with pytest.raises(ValueError):
        fj.join_count(bk, bk, bk, strategy="vmem")
    with pytest.raises(ValueError):
        fj.join_materialize(bk, bk, bk, strategy="vmem")
    with pytest.raises(ValueError):
        engine._graph_fn(10, 10, "count", "vmem", False, DEFAULT_CONFIG, 4)


@pytest.mark.parametrize("strategy", ["radix", "", "Global", "bucket"])
def test_unknown_strategy_raises(strategy):
    from flash_hash_join_tpu import engine
    bk = np.arange(10, dtype=np.uint64)
    with pytest.raises(ValueError):
        fj.join_count(bk, bk, bk, strategy=strategy)
    for mode in ("count", "materialize"):
        with pytest.raises(ValueError):
            engine._graph_fn(10, 10, mode, strategy, False, DEFAULT_CONFIG,
                             4)


def test_global_overflow_falls_back_exactly():
    """Force global-table overflow (a table far too small for the build)
    and check the API silently reruns with merge and stays exact."""
    import dataclasses
    from flash_hash_join_tpu import api
    from flash_hash_join_tpu.engine import JoinEngine
    rng = np.random.default_rng(2)
    bk = np.concatenate([np.full(5_000, 99, np.uint64),
                         rng.integers(0, 2**63, 5_000, dtype=np.uint64)])
    bv = rng.integers(0, 2**63, len(bk), dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 20_000),
                         rng.integers(0, 2**63, 20_000, dtype=np.uint64)])
    eng = api.default_engine()
    saved = eng.cfg
    eng.cfg = dataclasses.replace(saved, growth=0.05, overflow_groups=1)
    try:
        count, _, info = api._run_join(bk, bv, pk, mode="count",
                                       strategy="global", use_bloom=False,
                                       return_info=True)
    finally:
        eng.cfg = saved
    assert isinstance(eng, JoinEngine)
    assert count == oracle_count(bk, pk)
    assert info["strategy"] == "merge"


def test_merge_strategy_via_extended_api():
    rng = np.random.default_rng(3)
    bk = rng.integers(0, 5_000, 4_000, dtype=np.uint64)
    bv = rng.integers(0, 2**63, 4_000, dtype=np.uint64)
    pk = rng.integers(0, 5_000, 4_000, dtype=np.uint64)
    c1, _ = fj.join_count(bk, bv, pk, strategy="merge")
    c2, _ = fj.join_count(bk, bv, pk, strategy="global")
    c3, _ = fj.join_count(bk, bv, pk, strategy="partitioned")
    assert c1 == c2 == c3 == oracle_count(bk, pk)


def test_api_narrow_density_mismatch_ladder():
    """Probe keys spanning a wider range than build keys: the adaptive
    path (dense build domain) stays exact for count and materialize."""
    import flash_hash_join_tpu as fj

    rng = np.random.default_rng(31)
    nb, npr = 20_000, 50_000
    bk = rng.permutation(np.arange(nb, dtype=np.uint64))
    bv = rng.integers(0, 2**31, nb, dtype=np.uint64)
    pk = rng.integers(0, 2 * nb, npr, dtype=np.uint64)
    expected = int(np.isin(pk, bk).sum())
    count, _ = fj.adaptive_join_count(bk, bv, pk)
    assert count == expected
    count2, _, keys, vals = fj.join_materialize(bk, bv, pk,
                                                return_arrays=True)
    assert count2 == expected
    lut = dict(zip(bk.tolist(), bv.tolist()))
    assert all(lut[k] == v for k, v in zip(keys.tolist(), vals.tolist()))


def test_measure_device_seconds_chained_invariance():
    """The chained-delta device timer must reproduce the exact count on
    every remixed step (engine._compiled_chained) for count AND
    materialize, on both the partitioned and global strategies."""
    rng = np.random.default_rng(7)
    nb, npr = 30_000, 60_000
    bk = rng.integers(0, 40_000, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    pk = rng.integers(0, 40_000, npr, dtype=np.uint64)
    want = oracle_count(bk, pk)
    for mode in ("count", "materialize"):
        for strat in ("adaptive", "global"):
            count, dev, single, chained = fj.measure_device_seconds(
                bk, bv, pk, mode=mode, strategy=strat, reps=3, number=1)
            assert count == want, (mode, strat, count, want)
            assert dev > 0 and single > 0


def test_bloom_alias_introspection():
    # bloom only changes the compiled graph on the global strategy
    assert fj.bloom_is_distinct(10_000, 10_000, strategy="global")
    assert not fj.bloom_is_distinct(10_000, 10_000, strategy="partitioned")
    assert fj.plan_strategy(10_000, 10_000) in (
        "partitioned", "global", "merge")


def test_bloom_alias_reuses_compiled_program():
    """use_bloom must not change the compile-cache key off the global
    strategy — the alias twins share one AOT-compiled program."""
    from flash_hash_join_tpu.engine import default_engine

    eng = default_engine()
    a = eng.prepare(1000, 2000, "count", "partitioned", False)
    b = eng.prepare(1000, 2000, "count", "partitioned", True)
    assert a is b
    g1 = eng.prepare(1000, 2000, "count", "global", False)
    g2 = eng.prepare(1000, 2000, "count", "global", True)
    assert g1 is not g2
