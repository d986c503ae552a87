"""Range table + per-probe binary search (ops/range_table.py).

The partitioned ("radix") strategy's engine: the build side sorted by
(key, row) is the table, and each probe resolves by a lower-bound search.
Oracle parity across adversarial distributions, the max-key side channel,
and the Pallas Triton search kernel (interpret mode) against the plain one.
"""

import collections

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flash_hash_join_tpu.ops import range_table as rt
from flash_hash_join_tpu.utils import u64
from tests.oracle import oracle_count

M64 = np.uint64(2**64 - 1)


def _args(bk, bv, pk, nb=None, npr=None):
    kh, kl = u64.split_u64(bk)
    vh, vl = u64.split_u64(bv)
    ph, pl = u64.split_u64(pk)
    return (jnp.asarray(kh), jnp.asarray(kl), jnp.asarray(vh),
            jnp.asarray(vl), jnp.asarray(ph), jnp.asarray(pl),
            jnp.int32(nb if nb is not None else len(bk)),
            jnp.int32(npr if npr is not None else len(pk)))


def _count(bk, bv, pk, allow_unresolved=False, **kw):
    c, special = rt.range_join_count(*_args(bk, bv, pk), **kw)
    if not allow_unresolved:
        assert int(special[3]) == 0
    return int(c), int(special[3])


def _materialize(bk, bv, pk, **kw):
    out = rt.range_join_materialize(*_args(bk, bv, pk), **kw)
    count = int(out[0])
    keys = u64.join_u64(np.asarray(out[1]), np.asarray(out[2]))[:count]
    vals = u64.join_u64(np.asarray(out[3]), np.asarray(out[4]))[:count]
    return count, keys, vals, int(out[5][3])


@pytest.mark.parametrize("nb,npr", [(700, 5000), (20_000, 60_000),
                                    (60_000, 20_000)])
def test_range_count_random(nb, npr):
    rng = np.random.default_rng(nb + npr)
    bk = rng.integers(0, int(nb * 1.5), nb, dtype=np.uint64)
    bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    pk = rng.integers(0, int(nb * 1.5), npr, dtype=np.uint64)
    c, _ = _count(bk, bv, pk)
    assert c == oracle_count(bk, pk)


def test_range_count_match_extremes():
    rng = np.random.default_rng(0)
    bk = rng.integers(0, 2**63, 10_000, dtype=np.uint64)
    bv = bk + np.uint64(1)
    # 0% match: disjoint key ranges
    pk = rng.integers(2**63, 2**64 - 2, 30_000, dtype=np.uint64)
    c, _ = _count(bk, bv, pk)
    assert c == 0
    # 100% match
    pk = rng.choice(bk, 30_000)
    c, _ = _count(bk, bv, pk)
    assert c == 30_000


def test_range_count_sentinel_key():
    rng = np.random.default_rng(1)
    bk = rng.integers(0, 1000, 5000, dtype=np.uint64)
    bk[17] = M64
    bv = np.arange(5000, dtype=np.uint64)
    pk = np.concatenate([rng.integers(0, 1000, 7000, dtype=np.uint64),
                         np.full(9, M64, np.uint64)])
    c, _ = _count(bk, bv, pk)
    assert c == oracle_count(bk, pk)
    # and when the build does NOT contain the max key
    bk2 = np.where(bk == M64, np.uint64(5), bk)
    c2, _ = _count(bk2, bv, pk)
    assert c2 == oracle_count(bk2, pk)


def test_range_count_zipf_skew():
    rng = np.random.default_rng(2)
    zipf = np.minimum(rng.zipf(1.3, 40_000), 2**40).astype(np.uint64)
    bk = zipf
    bv = bk * np.uint64(3)
    pk = np.minimum(rng.zipf(1.3, 90_000), 2**40).astype(np.uint64)
    c, unres = _count(bk, bv, pk)
    assert unres == 0
    assert c == oracle_count(bk, pk)


def test_range_unresolved_triggers_on_giant_dup_run():
    """A giant run of one build key: the binary search has no window to
    overflow, so every probe resolves (unresolved == 0) and the count is
    exact."""
    nb = 120_000
    bk = np.full(nb, 42, np.uint64)
    bk[: 2000] = np.arange(2000, dtype=np.uint64) + 100
    bv = np.arange(nb, dtype=np.uint64)
    rng = np.random.default_rng(3)
    pk = rng.integers(0, 4000, 50_000, dtype=np.uint64)
    c, unres = _count(bk, bv, pk)
    assert unres == 0
    assert c == oracle_count(bk, pk)


def test_range_count_padding_and_nvalid():
    rng = np.random.default_rng(4)
    bk = rng.integers(0, 500, 3000, dtype=np.uint64)
    bv = rng.integers(0, 2**63, 3000, dtype=np.uint64)
    pk = rng.integers(0, 500, 10_000, dtype=np.uint64)
    args = _args(bk, bv, pk, nb=2000, npr=7000)
    c, special = rt.range_join_count(*args)
    assert int(special[3]) == 0
    assert int(c) == oracle_count(bk[:2000], pk[:7000])


def test_range_materialize_values_unique_keys():
    rng = np.random.default_rng(5)
    bk = rng.permutation(np.arange(30_000, dtype=np.uint64))
    bv = bk * np.uint64(7) + np.uint64(1)
    pk = rng.integers(0, 60_000, 50_000, dtype=np.uint64)
    c, keys, vals, unres = _materialize(bk, bv, pk)
    assert unres == 0
    assert c == oracle_count(bk, pk)
    # exact value parity on unique build keys
    assert np.all(vals == keys * np.uint64(7) + np.uint64(1))
    # key multiset parity
    want = collections.Counter(
        k for k in pk.tolist() if k < 30_000)
    assert collections.Counter(keys.tolist()) == want


def test_range_materialize_dups_and_sentinel():
    rng = np.random.default_rng(6)
    bk = rng.integers(0, 300, 4000, dtype=np.uint64)
    bk[7] = M64
    bv = rng.integers(0, 2**63, 4000, dtype=np.uint64)
    pk = np.concatenate([rng.integers(0, 400, 9000, dtype=np.uint64),
                         np.full(3, M64, np.uint64)])
    c, keys, vals, unres = _materialize(bk, bv, pk)
    assert unres == 0
    assert c == oracle_count(bk, pk)
    first = {}
    for k, v in zip(bk.tolist(), bv.tolist()):
        first.setdefault(k, v)
    assert all(k in first for k in keys.tolist())
    want = collections.Counter(k for k in pk.tolist() if k in first)
    assert collections.Counter(keys.tolist()) == want
    # sentinel value is the first max-key build row's value
    for k, v in zip(keys.tolist(), vals.tolist()):
        if k == int(M64):
            assert v == first[int(M64)]


def test_range_tiny_build_and_probe():
    bk = np.array([5, 9], dtype=np.uint64)
    bv = np.array([50, 90], dtype=np.uint64)
    pk = np.array([9, 9, 5, 1], dtype=np.uint64)
    c, keys, vals, unres = _materialize(bk, bv, pk)
    assert unres == 0
    assert c == 3
    assert sorted(zip(keys.tolist(), vals.tolist())) == [
        (5, 50), (9, 90), (9, 90)]


# ---- narrow (32-bit key) variant ----------------------------------------

def test_range_narrow_count_and_values():
    rng = np.random.default_rng(7)
    nb, npr = 25_000, 70_000
    bk = rng.permutation(np.arange(nb, dtype=np.uint64) * np.uint64(2))
    bv = bk + np.uint64(9)
    pk = rng.integers(0, 2 * nb, npr, dtype=np.uint64)
    c, unres = _count(bk, bv, pk, narrow=True)
    assert c == oracle_count(bk, pk)
    c2, keys, vals, unres2 = _materialize(bk, bv, pk, narrow=True)
    assert unres2 == 0
    assert c2 == oracle_count(bk, pk)
    assert np.all(vals == keys + np.uint64(9))


def test_range_narrow_sentinel_u32max():
    rng = np.random.default_rng(8)
    bk = rng.integers(0, 1000, 5000, dtype=np.uint64)
    bk[11] = 2**32 - 1
    bv = np.arange(5000, dtype=np.uint64)
    pk = np.concatenate([rng.integers(0, 1200, 8000, dtype=np.uint64),
                         np.full(5, 2**32 - 1, np.uint64)])
    c, _ = _count(bk, bv, pk, narrow=True)
    assert c == oracle_count(bk, pk)


def test_api_narrow_detection_routes_and_matches():
    import flash_hash_join_tpu as fj
    rng = np.random.default_rng(9)
    bk = rng.integers(0, 50_000, 30_000, dtype=np.uint64)  # 32-bit keys
    bv = rng.integers(0, 2**63, 30_000, dtype=np.uint64)   # 64-bit values
    pk = rng.integers(0, 50_000, 50_000, dtype=np.uint64)
    c, _ = fj.join_count(bk, bv, pk, strategy="partitioned")
    assert c == oracle_count(bk, pk)
    # wide keys on the same shapes still work (separate compile cache key)
    bk64 = bk + np.uint64(2**40)
    pk64 = pk + np.uint64(2**40)
    c2, _ = fj.join_count(bk64, bv, pk64, strategy="partitioned")
    assert c2 == oracle_count(bk64, pk64)


# ---- table shapes ---------------------------------------------------------

@pytest.mark.parametrize("narrow", [False, True])
def test_range_small_mode_exact(narrow):
    """Small builds with a max-key sentinel and duplicates, count and
    materialize, both key widths."""
    rng = np.random.default_rng(20)
    nb, npr = 9000, 40000
    bk = rng.integers(0, 12000, nb, dtype=np.uint64)
    bk[5] = (2**32 - 1) if narrow else np.uint64(2**64 - 1)
    bv = rng.integers(0, 2**62, nb, dtype=np.uint64)
    pk = rng.integers(0, 15000, npr, dtype=np.uint64)
    pk[:4] = bk[5]
    c, unres = _count(bk, bv, pk, narrow=narrow)
    assert unres == 0
    assert c == oracle_count(bk, pk)
    c2, keys, vals, unres2 = _materialize(bk, bv, pk, narrow=narrow)
    assert unres2 == 0 and c2 == c
    first = {}
    for k, v in zip(bk.tolist(), bv.tolist()):
        first.setdefault(k, v)
    want = collections.Counter(k for k in pk.tolist() if k in first)
    assert collections.Counter(keys.tolist()) == want
    # first-match winner: the first input occurrence of each key
    assert all(first[k] == v for k, v in zip(keys.tolist(), vals.tolist()))


def test_range_small_mode_always_exact_on_dups():
    """An all-duplicate build resolves exactly with unresolved == 0."""
    bk = np.full(10000, 7, np.uint64)
    bv = np.arange(10000, dtype=np.uint64)
    pk = np.array([7, 8, 7, 9] * 2500, dtype=np.uint64)
    c, unres = _count(bk, bv, pk)
    assert unres == 0
    assert c == 5000
    c2, keys, vals, _ = _materialize(bk, bv, pk)
    assert c2 == 5000 and set(vals.tolist()) == {0}


def test_range_narrow_values_specialization():
    """32-bit values keep the hi plane out of the sort and the table; the
    engine detects it host-side (api) — exercised here at the op level."""
    rng = np.random.default_rng(21)
    nb, npr = 20_000, 50_000
    bk = rng.permutation(np.arange(nb, dtype=np.uint64))
    bv = rng.integers(0, 2**31, nb, dtype=np.uint64)
    pk = rng.integers(0, 2 * nb, npr, dtype=np.uint64)
    out = rt.range_join_materialize(*_args(bk, bv, pk), narrow=True,
                                    narrow_values=True)
    c = int(out[0])
    assert int(out[-1][3]) == 0
    assert c == oracle_count(bk, pk)
    keys = u64.join_u64(np.asarray(out[1]), np.asarray(out[2]))[:c]
    vals = u64.join_u64(np.asarray(out[3]), np.asarray(out[4]))[:c]
    lut = dict(zip(bk.tolist(), bv.tolist()))
    assert all(lut[k] == v for k, v in zip(keys.tolist(), vals.tolist()))


def test_range_keyorder_wide_exact():
    """64-bit keys clustered in the high half: the lexicographic (hi, lo)
    search stays exact."""
    rng = np.random.default_rng(22)
    nb, npr = 30_000, 90_000
    bk = rng.integers(2**40, 2**63, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**62, nb, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, npr // 2),
                         rng.integers(2**40, 2**63, npr // 2,
                                      dtype=np.uint64)])
    c, sp = rt.range_join_count(*_args(bk, bv, pk))
    assert int(sp[3]) == 0
    assert int(c) == oracle_count(bk, pk)


def test_api_order_retry_ladder_on_density_mismatch():
    """Clustered 32-bit build keys + uniform probes: the narrow search has
    no density assumption, so the api answers exactly on the first try."""
    import flash_hash_join_tpu as fj
    from flash_hash_join_tpu import api
    rng = np.random.default_rng(23)
    nb, npr = 30_000, 90_000
    bk = rng.integers(50_000, 250_000, nb, dtype=np.uint64)  # dense cluster
    bv = rng.integers(0, 2**62, nb, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 1000),
                         rng.integers(0, 2**31, npr - 1000,
                                      dtype=np.uint64)])
    c, _ = fj.join_count(bk, bv, pk, strategy="partitioned")
    assert c == oracle_count(bk, pk)
    _, _, info = api._run_join(bk, bv, pk, mode="count",
                               strategy="partitioned", use_bloom=False,
                               return_info=True)
    assert info["strategy"] == "partitioned" and info["narrow"]


def test_blockwise_probe_mode_exact():
    """Mid-size build + big probe side, narrow keys and values: count and
    materialize stay exact, including max-key sentinels and duplicate
    build keys."""
    nb, npr = 30_000, 200_000
    rng = np.random.default_rng(5)
    bk = rng.integers(0, 40_000, nb, dtype=np.uint32)
    bk[7] = 2**32 - 1              # max-key sentinel in the build
    bv = rng.integers(0, 2**31, nb, dtype=np.uint32)
    pk = rng.integers(0, 40_000, npr, dtype=np.uint32)
    pk[123:150] = 2**32 - 1        # max-key probes
    pk[-20:] = 2**32 - 1
    expected = int(np.isin(pk, bk).sum())

    z = jnp.zeros((nb,), jnp.uint32)
    zp = jnp.zeros((npr,), jnp.uint32)
    count, special = rt.range_join_count(
        z, jnp.asarray(bk), z, jnp.asarray(bv), zp, jnp.asarray(pk),
        nb, npr, narrow=True)
    assert int(special[3]) == 0
    assert int(count) == expected

    out = rt.range_join_materialize(
        z, jnp.asarray(bk), z, jnp.asarray(bv), zp, jnp.asarray(pk),
        nb, npr, narrow=True, narrow_values=True)
    cnt = int(out[0])
    assert int(out[-1][3]) == 0
    assert cnt == expected
    keys = np.asarray(out[2])[:cnt]
    vals = np.asarray(out[4])[:cnt]
    mask = np.isin(pk, bk)
    # probe order, and each value is the key's first build occurrence
    assert np.array_equal(keys, pk[mask])
    first = {}
    for k, v in zip(bk.tolist(), bv.tolist()):
        first.setdefault(k, v)
    assert all(first[k] == v for k, v in zip(keys.tolist(), vals.tolist()))


def test_blockwise_validity_tail():
    """Validity boundaries (host-chunk tails) stay exact wherever they
    fall, on both sides."""
    nb, npr = 20_000, 160_000
    rng = np.random.default_rng(6)
    bk = rng.integers(0, 25_000, nb, dtype=np.uint32)
    pk = rng.integers(0, 25_000, npr, dtype=np.uint32)
    z = jnp.zeros((nb,), jnp.uint32)
    zp = jnp.zeros((npr,), jnp.uint32)
    for nbv, nvalid in ((nb, 140_000), (nb, 66_536), (12_345, npr)):
        expected = int(np.isin(pk[:nvalid], bk[:nbv]).sum())
        count, special = rt.range_join_count(
            z, jnp.asarray(bk), z, z, zp, jnp.asarray(pk), nbv, nvalid,
            narrow=True)
        assert int(special[3]) == 0, (nbv, nvalid)
        assert int(count) == expected, (nbv, nvalid)


# ---- the search itself: plain jnp vs the Pallas Triton kernel -------------

def _search_case(nt, m, seed, wide):
    rng = np.random.default_rng(seed)
    hi = 2**64 - 1 if wide else 2**32 - 1
    t = np.sort(rng.integers(0, hi, nt, dtype=np.uint64)) if nt > 3 else \
        np.sort(rng.integers(0, 9, nt, dtype=np.uint64))
    p = np.concatenate([rng.choice(t, m // 2) if nt else
                        np.zeros(0, np.uint64),
                        rng.integers(0, hi, m - (m // 2 if nt else 0),
                                     dtype=np.uint64)])
    ls = np.searchsorted(t, p)
    want = np.where((ls < nt) & (t[np.minimum(ls, max(nt - 1, 0))] == p)
                    if nt else False, ls, -1)

    def planes(a):
        h, lo = u64.split_u64(a)
        return (jnp.asarray(h), jnp.asarray(lo)) if wide else \
            (jnp.asarray(lo),)
    return planes(t), planes(p), want


@pytest.mark.parametrize("nt,m,seed,wide", [
    (1, 100, 0, True), (5, 3000, 1, False), (4096, 5000, 2, True),
    (70_000, 9_000, 3, False), (0, 50, 4, True),
])
def test_search_matches_numpy(nt, m, seed, wide):
    t, p, want = _search_case(nt, m, seed, wide)
    np.testing.assert_array_equal(np.asarray(rt.search(t, p)), want)


@pytest.mark.parametrize("nt,m,seed,wide", [
    (1, 100, 0, True), (5, 3000, 1, False), (4096, 5000, 2, True),
    (70_000, 9_000, 3, False), (0, 50, 4, True),
])
def test_triton_search_matches_plain(nt, m, seed, wide):
    from flash_hash_join_tpu.ops.pallas import range_probe as rp
    t, p, want = _search_case(nt, m, seed, wide)
    got = np.asarray(rp.search(t, p, interpret=True))
    np.testing.assert_array_equal(got, np.asarray(rt.search(t, p)))
    np.testing.assert_array_equal(got, want)


def test_search_first_occurrence_of_duplicates():
    t = (jnp.asarray(np.array([1, 3, 3, 3, 8, 8], np.uint32)),)
    p = (jnp.asarray(np.array([3, 8, 0, 9, 1], np.uint32)),)
    np.testing.assert_array_equal(np.asarray(rt.search(t, p)),
                                  [1, 4, -1, -1, 0])
