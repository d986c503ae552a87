"""Large-span dense-domain bitmap count (ops/direct_bitmap.py).

Parity vs numpy membership counting at spans past one bitmap row rung,
plus the exactness escape hatch (bad build rows) and key-space gaps.
Reference cells this strategy replaces: the radix and scalar count
drivers, hash_join.cpp:498-534, :536-567.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from flash_hash_join_tpu.ops import direct_bitmap as db
from flash_hash_join_tpu.utils import u64


def _run_large(bk, pk, nb_valid=None, np_valid=None, d_rows=None, **kw):
    kh, kl = u64.split_u64(np.asarray(bk, np.uint64))
    ph, pl = u64.split_u64(np.asarray(pk, np.uint64))
    nb = np.int32(len(bk) if nb_valid is None else nb_valid)
    npv = np.int32(len(pk) if np_valid is None else np_valid)
    span = int(bk.max() - bk.min() + 1) if len(bk) else 1
    cnt, special = db.direct_join_count(
        jnp.asarray(kh), jnp.asarray(kl), jnp.asarray(ph), jnp.asarray(pl),
        nb, npv, d_rows=d_rows or db.d_rows_for(span), **kw)
    return int(cnt), int(np.asarray(special)[3])


@pytest.mark.parametrize("nb,npr,span,lo", [
    (9_000, 14_000, 10_000, 0),
    (9_000, 14_000, 10_000, 123_456_789),    # nonzero domain base
    (5_000, 8_000, 5_500, 7),                # smaller than one sort block
    (300, 500, 64, 0),                       # tiny
])
def test_parity_uniform(nb, npr, span, lo):
    rng = np.random.default_rng(nb + span)
    bk = rng.integers(lo, lo + span, nb, dtype=np.uint64)
    pk = rng.integers(lo, lo + int(span * 1.3), npr, dtype=np.uint64)
    cnt, sp3 = _run_large(bk, pk)
    assert sp3 == 0
    assert cnt == int(np.isin(pk, bk).sum())


def test_duplicate_build_keys_first_match_semantics():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4_000, 2_000, dtype=np.uint64)
    bk = np.concatenate([base, base, base[:500]])      # heavy duplication
    pk = rng.integers(0, 5_000, 6_000, dtype=np.uint64)
    cnt, sp3 = _run_large(bk, pk)
    assert sp3 == 0
    # probe multiplicity counts, build multiplicity does not
    assert cnt == int(np.isin(pk, bk).sum())


def test_validity_tails():
    rng = np.random.default_rng(4)
    bk = rng.integers(0, 10_000, 6_000, dtype=np.uint64)
    pk = rng.integers(0, 12_000, 7_000, dtype=np.uint64)
    nbv, npv = 5_000, 6_500
    cnt, sp3 = _run_large(bk, pk, nb_valid=nbv, np_valid=npv)
    assert sp3 == 0
    assert cnt == int(np.isin(pk[:npv], bk[:nbv]).sum())


def test_bad_build_rows_flagged():
    # hi-word keys cannot live in the u32 domain: counted into special[3]
    bk = np.array([1, 2, 3, 2**40], dtype=np.uint64)
    pk = np.array([1, 2, 9], dtype=np.uint64)
    cnt, sp3 = _run_large(bk, pk, d_rows=8)
    assert sp3 > 0


def test_gap_overflow_unresolved():
    # a key-space gap across most of the domain: direct addressing has no
    # window, so nothing is unresolved and the count stays exact
    d_rows = 512
    d_bits = d_rows * 4096
    bk = np.concatenate([
        np.arange(1_000, dtype=np.uint64),
        np.arange(d_bits - 1_000, d_bits, dtype=np.uint64),
    ])
    pk = np.concatenate([np.arange(500, dtype=np.uint64),
                         np.arange(d_bits - 700, d_bits, dtype=np.uint64)])
    cnt, sp3 = _run_large(bk, pk, d_rows=d_rows)
    assert sp3 == 0
    assert cnt == int(np.isin(pk, bk).sum())


def test_empty_sides():
    bk = np.array([], dtype=np.uint64)
    pk = np.arange(100, dtype=np.uint64)
    cnt, sp3 = _run_large(bk, pk, d_rows=8)
    assert (cnt, sp3) == (0, 0)
    cnt, sp3 = _run_large(pk, bk, d_rows=8)
    assert (cnt, sp3) == (0, 0)


def test_fuzz_small_shapes():
    rng = np.random.default_rng(11)
    for it in range(6):
        nb = int(rng.integers(1, 4_000))
        npr = int(rng.integers(1, 4_000))
        span = int(rng.integers(1, 30_000))
        lo = int(rng.integers(0, 2**31))
        bk = rng.integers(lo, lo + span, nb, dtype=np.uint64)
        pk = rng.integers(lo, lo + int(span * 1.5) + 2, npr,
                          dtype=np.uint64)
        cnt, sp3 = _run_large(bk, pk)
        assert sp3 == 0, it
        assert cnt == int(np.isin(pk, bk).sum()), it


def test_xl_rung_math():
    # rungs are pow2 bitmap rows of 4096 slots, covering any span
    assert db.d_rows_for(110_000_000) == 32768      # the 1e8 J1 universe
    for span in (1, 4096, 2**20, 2**25, 90_000_000, db.MAX_DOMAIN_SLOTS):
        r = db.d_rows_for(span)
        assert r * 4096 >= span
        assert r & (r - 1) == 0
        assert r == 8 or (r // 2) * 4096 < span


def test_dense_domain_rule_j1_1e8():
    # the 1e8 J1 Q5 shape: span 1.1e8, nb = npr = 1e8 -> dense
    assert db.dense_domain_ok(110_000_000, 100_000_000, 100_000_000)
    # the same span under a thin build and probe side is not
    assert not db.dense_domain_ok(110_000_000, 1_000_000, 1_000_000)
