"""Direct-address bitmap count strategy (ops/direct_bitmap.py).

The dense-domain count tier: parity vs the numpy oracle across domain
offsets, duplicates, misses, wide (>=2^32) probe keys, and validity
tails; the out-of-domain special-channel fallback; and the dense-domain
rule api.py applies.
"""

import numpy as np
import pytest

import flash_hash_join_tpu as fj
from flash_hash_join_tpu import api
from flash_hash_join_tpu.ops import direct_bitmap as db
from flash_hash_join_tpu.utils import u64

from tests.oracle import oracle_count


def _case(rng, nb, universe, npr, offset=0, wide_probes=0):
    bk = (rng.integers(0, universe, nb) + offset).astype(np.uint64)
    bv = rng.integers(1, 101, nb).astype(np.uint64)
    pk = (rng.integers(0, int(universe * 1.2) + 1, npr) + offset).astype(
        np.uint64)
    if wide_probes:
        pk[:wide_probes] = rng.integers(2**32, 2**40, wide_probes)
    return bk, bv, pk


@pytest.mark.parametrize("offset", [0, 1_000_000, 4_000_000_000])
def test_direct_count_parity(offset):
    rng = np.random.default_rng(11 + offset % 7)
    bk, bv, pk = _case(rng, 4_000, 4_400, 50_000, offset=offset,
                       wide_probes=64 if offset == 0 else 0)
    want = oracle_count(bk, pk)
    count, _ = fj.join_count(bk, bv, pk, strategy="direct")
    assert count == want


def test_direct_q1_tiny_build():
    rng = np.random.default_rng(5)
    bk, bv, pk = _case(rng, 40, 44, 30_000)
    assert fj.join_count(bk, bv, pk, strategy="direct")[0] == \
        oracle_count(bk, pk)


def test_direct_duplicate_build_keys_count_once():
    bk = np.array([7, 7, 7, 9, 9], np.uint64)
    bv = np.arange(5).astype(np.uint64)
    pk = np.array([7, 9, 9, 8, 7], np.uint64)
    # first-match semantics: probe multiplicity counts, build's does not
    assert fj.join_count(bk, bv, pk, strategy="direct")[0] == 4


def test_direct_rejects_wide_or_sparse():
    rng = np.random.default_rng(1)
    bv = np.ones(100, np.uint64)
    pk = rng.integers(0, 100, 1000).astype(np.uint64)
    wide = rng.integers(2**32, 2**40, 100).astype(np.uint64)
    with pytest.raises(ValueError):
        fj.join_count(wide, bv, pk, strategy="direct")
    sparse = rng.integers(0, 2**32, 100).astype(np.uint64)  # span > 2^30
    sparse[0], sparse[1] = 0, 2**32 - 1
    with pytest.raises(ValueError):
        fj.join_count(sparse, bv, sparse, strategy="direct")


def test_adaptive_upgrades_dense_count_only():
    rng = np.random.default_rng(2)
    bk, bv, pk = _case(rng, 40_000, 44_000, 1 << 17)
    _, _, info = api._run_join(bk, bv, pk, mode="count",
                               strategy="adaptive", use_bloom=False,
                               return_info=True)
    assert info["strategy"] == "direct" and info["d_rows"] > 0
    # materialize takes the direct row plane too
    _, _, info = api._run_join(bk, bv, pk, mode="materialize",
                               strategy="adaptive", use_bloom=False,
                               return_info=True)
    assert info["strategy"] == "direct"
    # sparse 64-bit keys: adaptive silently keeps the regular plan
    wide = rng.integers(0, 2**62, 40_000).astype(np.uint64)
    wpk = rng.integers(0, 2**62, 1 << 17).astype(np.uint64)
    _, _, info = api._run_join(wide, bv, wpk, mode="count",
                               strategy="adaptive", use_bloom=False,
                               return_info=True)
    assert info["strategy"] != "direct"


def test_adaptive_gates_by_measured_crossover():
    # Adaptive routes direct exactly when the dense-domain rule holds:
    # span <= DENSE_SLOTS_PER_ROW slots per input row (build + probe).
    rng = np.random.default_rng(6)
    nb = npr = 1 << 14
    cap = db.DENSE_SLOTS_PER_ROW * (nb + npr)
    bv = rng.integers(1, 101, nb).astype(np.uint64)
    pk = rng.integers(0, cap, npr).astype(np.uint64)
    for span, routed in ((cap, True), (cap + 1, False)):
        bk = rng.integers(0, span, nb).astype(np.uint64)
        bk[:2] = (0, span - 1)  # pin the span
        count, _, info = api._run_join(bk, bv, pk, mode="count",
                                       strategy="adaptive", use_bloom=False,
                                       return_info=True)
        assert (info["strategy"] == "direct") == routed, span
        assert count == oracle_count(bk, pk)


def test_dense_domain_rule_boundaries():
    # the rule's boundaries: J1 Q1/Q2/Q5 spans (1.1x the build) route
    # direct at every scale; a sparse span or one past the cap does not
    for n in (10**7, 10**8):
        for nb in (n // 10**6, n // 1000, n):
            assert db.dense_domain_ok(int(nb * 1.1) + 1, nb, n)
    assert not db.dense_domain_ok(2**31, 10**6, 10**6)
    assert not db.dense_domain_ok(db.MAX_DOMAIN_SLOTS + 1, 10**9, 10**9)
    assert db.dense_domain_ok(db.MAX_DOMAIN_SLOTS, 10**9, 10**9)


def test_out_of_domain_special_channel():
    # engine-level: a rung too small for the span must COUNT the overflow
    # (the api retry ladder then reruns on merge), never miscount silently
    rng = np.random.default_rng(3)
    bk = rng.integers(0, 100_000, 2_000).astype(np.uint64)  # span > 8 rows
    pk = rng.integers(0, 100_000, 9_000).astype(np.uint64)
    kh, kl = u64.split_u64(bk)
    ph, pl = u64.split_u64(pk)
    count, special = db.direct_join_count(
        kh, kl, ph, pl, np.int32(len(bk)), np.int32(len(pk)),
        d_rows=8)
    assert int(special[3]) > 0


def test_direct_validity_tail():
    rng = np.random.default_rng(4)
    bk, bv, pk = _case(rng, 1_000, 1_100, 9_000)
    kh, kl = u64.split_u64(bk)
    ph, pl = u64.split_u64(pk)
    valid = 7_333
    count, special = db.direct_join_count(
        kh, kl, ph, pl, np.int32(len(bk)), np.int32(valid),
        d_rows=db.d_rows_for(1_100))
    assert int(special[3]) == 0
    assert int(count) == oracle_count(bk, pk[:valid])


def test_d_rows_rungs():
    assert db.d_rows_for(1) == 8
    assert db.d_rows_for(8 * 4096) == 8
    assert db.d_rows_for(8 * 4096 + 1) == 16
    assert db.d_rows_for(44_000) == 16
    assert db.d_rows_for(1 << 20) == 256
    assert db.d_rows_for((1 << 20) + 1) == 512
