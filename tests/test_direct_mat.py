"""Dense-domain MATERIALIZE (ops/direct_bitmap.direct_join_materialize).

Parity vs the numpy oracle for small (one row rung) and large spans —
the row plane is a scatter-min of build rows, read by one gather per
probe — plus the exactness escape hatch.  Reference strategy being
replaced: count-then-write at exact offsets, hash_join.cpp:394-444.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import flash_hash_join_tpu as fj
from flash_hash_join_tpu.ops import direct_bitmap as db
from flash_hash_join_tpu.utils import u64
from tests.oracle import oracle_materialize


def _run_mat(bk, bv, pk, nb_valid=None, np_valid=None, v_rows=None,
             narrow_values=None, **kw):
    bk = np.asarray(bk, np.uint64)
    bv = np.asarray(bv, np.uint64)
    pk = np.asarray(pk, np.uint64)
    kh, kl = u64.split_u64(bk)
    vh, vl = u64.split_u64(bv)
    ph, pl = u64.split_u64(pk)
    nb = np.int32(len(bk) if nb_valid is None else nb_valid)
    npv = np.int32(len(pk) if np_valid is None else np_valid)
    span = int(bk.max() - bk.min() + 1) if len(bk) else 1
    if narrow_values is None:
        narrow_values = int(bv.max()) < 2**32 if len(bv) else True
    out = db.direct_join_materialize(
        jnp.asarray(kh), jnp.asarray(kl), jnp.asarray(vh), jnp.asarray(vl),
        jnp.asarray(ph), jnp.asarray(pl), nb, npv,
        v_rows=v_rows or db.v_rows_for(span),
        narrow_values=narrow_values, **kw)
    count = int(out[0])
    keys = u64.join_u64(np.asarray(out[1]), np.asarray(out[2]))[:count]
    vals = u64.join_u64(np.asarray(out[3]), np.asarray(out[4]))[:count]
    return count, keys, vals, int(np.asarray(out[5])[3])


def _assert_parity(bk, bv, pk, count, keys, vals, np_valid=None,
                   nb_valid=None):
    bk = np.asarray(bk, np.uint64)[:nb_valid]
    bv = np.asarray(bv, np.uint64)[:nb_valid]
    pk = np.asarray(pk, np.uint64)[:np_valid]
    co, ko, vo = oracle_materialize(bk, bv, pk)
    assert count == co
    assert sorted(keys.tolist()) == sorted(ko.tolist())
    if vo is not None:
        assert (sorted(zip(keys.tolist(), vals.tolist()))
                == sorted(zip(ko.tolist(), vo.tolist())))
    else:
        # duplicate build keys: any matching build row's value is legal
        legal = {}
        for k, v in zip(bk.tolist(), bv.tolist()):
            legal.setdefault(k, set()).add(v)
        for k, v in zip(keys.tolist(), vals.tolist()):
            assert v in legal[k], (k, v)


@pytest.mark.parametrize("nb,npr,span,lo,wide_vals", [
    (40, 6_000, 44, 1_000, False),              # Q1-like, v_rows = 8
    (900, 9_000, 1_000, 0, False),              # scan band, mid
    (900, 9_000, 1_000, 77, True),              # u64 values (2 planes)
    (3_000, 12_000, 16_000, 2**31, False),      # scan band top, big lo
])
def test_scan_band_parity(nb, npr, span, lo, wide_vals):
    rng = np.random.default_rng(nb + npr)
    bk = rng.integers(lo, lo + span, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**40 if wide_vals else 2**20, nb,
                      dtype=np.uint64)
    pk = rng.integers(lo, lo + int(span * 1.3) + 1, npr, dtype=np.uint64)
    count, keys, vals, sp3 = _run_mat(bk, bv, pk)
    assert sp3 == 0
    _assert_parity(bk, bv, pk, count, keys, vals)


@pytest.mark.parametrize("nb,npr,span,wide_vals", [
    (20_000, 40_000, 22_000, False),            # Q2-like staged band
    (18_000, 30_000, 20_000, True),             # u64 values (3 planes)
])
def test_staged_band_parity(nb, npr, span, wide_vals):
    rng = np.random.default_rng(span)
    bk = rng.integers(5, 5 + span, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**40 if wide_vals else 2**20, nb,
                      dtype=np.uint64)
    pk = rng.integers(0, 5 + int(span * 1.2), npr, dtype=np.uint64)
    assert db.v_rows_for(span) > 128
    count, keys, vals, sp3 = _run_mat(bk, bv, pk)
    assert sp3 == 0
    _assert_parity(bk, bv, pk, count, keys, vals)


def test_duplicate_build_keys_value_is_first_occurrence():
    rng = np.random.default_rng(7)
    base = rng.integers(0, 900, 600, dtype=np.uint64)
    bk = np.concatenate([base, base])
    bv = np.arange(1_200, dtype=np.uint64)       # row index as value
    pk = rng.integers(0, 1_100, 4_000, dtype=np.uint64)
    count, keys, vals, sp3 = _run_mat(bk, bv, pk)
    assert sp3 == 0
    _assert_parity(bk, bv, pk, count, keys, vals)
    # winner = MIN build-row index (first input occurrence): with values
    # equal to row ids, every output value must index a row holding the key
    # and be the smallest such row
    first = {}
    for i, k in enumerate(bk.tolist()):
        first.setdefault(k, i)
    for k, v in zip(keys.tolist(), vals.tolist()):
        assert v == first[k]


def test_validity_tails_both_bands():
    rng = np.random.default_rng(9)
    for span, nb, npr in ((900, 700, 5_000), (20_000, 15_000, 30_000)):
        bk = rng.integers(0, span, nb, dtype=np.uint64)
        bv = rng.integers(0, 2**20, nb, dtype=np.uint64)
        pk = rng.integers(0, int(span * 1.2), npr, dtype=np.uint64)
        nbv, npv = nb - 123, npr - 456
        count, keys, vals, sp3 = _run_mat(bk, bv, pk, nb_valid=nbv,
                                          np_valid=npv)
        assert sp3 == 0
        _assert_parity(bk, bv, pk, count, keys, vals, np_valid=npv,
                       nb_valid=nbv)


def test_bad_build_rows_flagged():
    bk = np.array([1, 2, 3, 2**40], dtype=np.uint64)
    bv = np.arange(4, dtype=np.uint64)
    pk = np.array([1, 2, 9], dtype=np.uint64)
    _, _, _, sp3 = _run_mat(bk, bv, pk, v_rows=8)
    assert sp3 > 0


def test_probe_hi_keys_never_match():
    bk = np.arange(100, dtype=np.uint64)
    bv = np.arange(100, dtype=np.uint64) * 3
    pk = np.array([5, 7, 5 + 2**33, 2**40, 99], dtype=np.uint64)
    count, keys, vals, sp3 = _run_mat(bk, bv, pk)
    assert sp3 == 0
    _assert_parity(bk, bv, pk, count, keys, vals)


def test_staged_gap_overflow_unresolved():
    # keys clustered at both ends of a 2^19-slot span: direct addressing
    # has no window, so the rows stay exact with nothing unresolved
    span = 1 << 19
    bk = np.concatenate([np.arange(500, dtype=np.uint64),
                         np.arange(span - 500, span, dtype=np.uint64)])
    bv = np.arange(1_000, dtype=np.uint64)
    pk = np.concatenate([np.arange(400, dtype=np.uint64),
                         np.arange(span - 400, span, dtype=np.uint64)])
    pk = np.tile(pk, 40)                                   # 32K probes
    count, keys, vals, sp3 = _run_mat(bk, bv, pk)
    assert sp3 == 0
    _assert_parity(bk, bv, pk, count, keys, vals)


def test_empty_and_all_miss():
    bk = np.arange(50, dtype=np.uint64)
    bv = np.arange(50, dtype=np.uint64)
    pk = np.arange(1_000, 2_000, dtype=np.uint64)          # all miss
    count, keys, vals, sp3 = _run_mat(bk, bv, pk, v_rows=8)
    assert (count, sp3) == (0, 0)


def test_api_adaptive_routes_dense_materialize():
    rng = np.random.default_rng(5)
    nb, npr = 900, 1_100_000          # v_rows=8
    bk = rng.permutation(nb).astype(np.uint64) + 1
    bv = rng.integers(1, nb, nb).astype(np.uint64)
    pk = rng.integers(1, int(nb * 1.1) + 1, npr).astype(np.uint64)
    count, _, info = fj.api._run_join(bk, bv, pk, mode="materialize",
                                      strategy="adaptive", use_bloom=False,
                                      return_info=True)
    assert info["strategy"] == "direct"
    assert count == int(np.isin(pk, bk).sum())
    # and the arrays are exact
    c2, _, keys, vals = fj.join_materialize(bk, bv, pk, return_arrays=True)
    _assert_parity(bk, bv, pk, c2, keys, vals)


def test_api_explicit_direct_materialize_staged():
    rng = np.random.default_rng(6)
    span = 40_000
    nb, npr = 30_000, 50_000
    bk = rng.integers(0, span, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**45, nb, dtype=np.uint64)
    pk = rng.integers(0, int(span * 1.15), npr, dtype=np.uint64)
    c, _, keys, vals = fj.join_materialize(bk, bv, pk, strategy="direct",
                                           return_arrays=True)
    _assert_parity(bk, bv, pk, c, keys, vals)


def test_api_direct_raises_on_sparse_or_wide():
    bk = np.array([0, 2**33], dtype=np.uint64)              # hi-word key
    bv = np.array([1, 2], dtype=np.uint64)
    pk = np.arange(10, dtype=np.uint64)
    with pytest.raises(ValueError):
        fj.join_materialize(bk, bv, pk, strategy="direct")


def test_v_rows_rung_math_and_gates():
    assert db.v_rows_for(1) == 8
    assert db.v_rows_for(128 * 128) == 128
    assert db.v_rows_for(128 * 128 + 1) == 256
    assert db.v_rows_for(1 << 20) == 8192
    for span in (1, 44, 11_000, 44_000, 1 << 20, 110_000_000):
        r = db.v_rows_for(span)
        assert r * 128 >= span
        assert r == 8 or (r // 2) * 128 < span
    # the dense-domain rule: Q2-4e7 passes, a thin side over a wide span
    # fails
    assert db.dense_domain_ok(44_000, 40_000, 40_000_000)
    assert not db.dense_domain_ok(1 << 22, 1_000, 300_000)
