"""Sort-merge join strategy vs oracle (same adversarial matrix as the table
path) + strategy selection."""

import numpy as np
import jax.numpy as jnp
import pytest

from flash_hash_join_tpu.ops import merge_join as mj
from flash_hash_join_tpu.utils import u64
from flash_hash_join_tpu.models.cost import choose_plan
from flash_hash_join_tpu.utils.config import DEFAULT_CONFIG
from tests.oracle import oracle_count, oracle_materialize


def _args(bk, bv, pk, nb=None, npr=None):
    kh, kl = u64.split_u64(bk)
    vh, vl = u64.split_u64(bv)
    ph, pl = u64.split_u64(pk)
    return (jnp.asarray(kh), jnp.asarray(kl), jnp.asarray(vh), jnp.asarray(vl),
            jnp.asarray(ph), jnp.asarray(pl),
            nb if nb is not None else len(bk),
            npr if npr is not None else len(pk))


@pytest.mark.parametrize("nb,npr", [(1000, 1000), (50, 5000), (5000, 50)])
def test_merge_count(nb, npr):
    rng = np.random.default_rng(nb + npr)
    bk = rng.integers(0, 2**64, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**64, nb, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, npr // 2),
                         rng.integers(0, 2**64, npr - npr // 2, dtype=np.uint64)])
    assert int(mj.merge_join_count(*_args(bk, bv, pk))) == oracle_count(bk, pk)


def test_merge_count_duplicates_and_sentinel():
    M = np.uint64(2**64 - 1)
    bk = np.array([7, 7, 7, M, 3], dtype=np.uint64)
    bv = np.array([70, 71, 72, 99, 30], dtype=np.uint64)
    pk = np.array([7, M, 4, 7, M, 3], dtype=np.uint64)
    assert int(mj.merge_join_count(*_args(bk, bv, pk))) == 5


def test_merge_materialize_unique_build():
    rng = np.random.default_rng(1)
    bk = np.unique(rng.integers(0, 2**63, 3000, dtype=np.uint64))
    bv = rng.integers(0, 2**64, len(bk), dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 2000),
                         rng.integers(0, 2**63, 1000, dtype=np.uint64)])
    count, okh, okl, ovh, ovl = mj.merge_join_materialize(*_args(bk, bv, pk))
    count = int(count)
    o_count, o_keys, o_vals = oracle_materialize(bk, bv, pk)
    assert count == o_count
    keys = u64.join_u64(np.asarray(okh), np.asarray(okl))[:count]
    vals = u64.join_u64(np.asarray(ovh), np.asarray(ovl))[:count]
    # merge output is hash-ordered; compare as multisets of (key, value)
    got = sorted(zip(keys.tolist(), vals.tolist()))
    want = sorted(zip(o_keys.tolist(), o_vals.tolist()))
    assert got == want


def test_merge_materialize_dup_values_legal():
    rng = np.random.default_rng(2)
    base = rng.integers(0, 2**63, 40, dtype=np.uint64)
    bk = np.repeat(base, 5)
    bv = rng.integers(0, 2**64, len(bk), dtype=np.uint64)
    pk = np.concatenate([base, rng.integers(0, 2**63, 60, dtype=np.uint64)])
    count, okh, okl, ovh, ovl = mj.merge_join_materialize(*_args(bk, bv, pk))
    count = int(count)
    assert count == oracle_count(bk, pk)
    keys = u64.join_u64(np.asarray(okh), np.asarray(okl))[:count]
    vals = u64.join_u64(np.asarray(ovh), np.asarray(ovl))[:count]
    legal = {}
    for k, v in zip(bk, bv):
        legal.setdefault(int(k), set()).add(int(v))
    for k, v in zip(keys, vals):
        assert int(v) in legal[int(k)]
    # all outputs for one key carry the SAME (first-writer) value
    seen = {}
    for k, v in zip(keys, vals):
        assert seen.setdefault(int(k), int(v)) == int(v)


def test_merge_validity_padding():
    rng = np.random.default_rng(3)
    bk = rng.integers(0, 1000, 500, dtype=np.uint64)
    bv = rng.integers(0, 2**64, 500, dtype=np.uint64)
    pk = rng.integers(0, 1000, 800, dtype=np.uint64)
    # padded copies that duplicate real keys must be ignored
    got = int(mj.merge_join_count(*_args(
        np.concatenate([bk, bk[:100]]), np.concatenate([bv, bv[:100]]),
        np.concatenate([pk, pk[:50]]), nb=300, npr=600)))
    assert got == oracle_count(bk[:300], pk[:600])


def test_cost_model_picks_partitioned_everywhere():
    # the plan always names the partitioned tier; api.py upgrades dense
    # domains to direct from the data
    for nb, npr in ((10_000_000, 10_000_000), (100_000, 100_000_000),
                    (1_000, 200_000), (30_000, 200_000)):
        assert choose_plan(nb, npr, DEFAULT_CONFIG).strategy == "partitioned"
