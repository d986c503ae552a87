"""Stream compaction (ops/compact.compact_by_mask) against numpy.

Oracle: numpy boolean-mask compaction.  Covers empty blocks, all-hit
blocks, ragged per-block hit runs, truncated outputs, and several sizes,
mask densities and column counts.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from flash_hash_join_tpu.ops.compact import compact_by_mask


def _check(mask, cols, n_out=None):
    count, outs = compact_by_mask(
        jnp.asarray(mask), tuple(jnp.asarray(c) for c in cols), n_out=n_out)
    want = int(mask.sum())
    assert int(count) == want
    keep = want if n_out is None else min(want, n_out)
    for o, c in zip(outs, cols):
        o = np.asarray(o)
        assert o.shape == (len(mask) if n_out is None else n_out,)
        np.testing.assert_array_equal(o[:keep], c[mask][:keep])  # stable
        assert not o[keep:].any()  # the tail is zero


@pytest.mark.parametrize("bm,nblocks,seed", [
    (8, 1, 0), (8, 3, 1), (16, 5, 2), (8, 4, 3),
])
def test_concat_ragged_blocks(bm, nblocks, seed):
    """Each block keeps a leading run of its rows (ragged block counts),
    the shape of a per-block compaction's concatenation."""
    rng = np.random.default_rng(seed)
    rows = nblocks * bm
    cols = [rng.integers(0, 2**32, rows * 128, dtype=np.uint32)
            for _ in range(2)]
    counts = rng.integers(0, bm * 128 + 1, nblocks)
    if seed == 1:
        counts[0] = 0            # empty leading block
        counts[-1] = bm * 128    # full trailing block
    if seed == 3:
        counts[:] = [1, 0, 127, 130][:nblocks]  # tiny runs straddling
    pos = np.arange(rows * 128) % (bm * 128)
    mask = pos < np.repeat(counts, bm * 128)
    _check(mask, cols)


@pytest.mark.parametrize("n,density,seed", [
    (1000, 0.5, 0), (4096, 1.0, 1), (70000, 0.03, 2), (131072, 0.0, 3),
    (65536, 0.97, 4), (5, 0.8, 5),
])
def test_compact_by_mask_stream(n, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < density
    cols = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(3)]
    _check(mask, cols)


@pytest.mark.parametrize("n,density,seed,bm,V", [
    (1000, 0.5, 0, 128, 2), (70000, 0.03, 2, 256, 4),
    (131072, 0.0, 3, 256, 3), (65536, 0.97, 4, 512, 4),
    (5, 0.8, 5, 128, 1), (40000, 1.0, 6, 256, 2),
    (99999, 0.33, 7, 1024, 4), (4096, 1.0, 8, 256, 1),
])
def test_compact_by_mask_pack(n, density, seed, bm, V):
    """V payload columns; masks clustered in runs of bm rows."""
    rng = np.random.default_rng(seed)
    runs = rng.random(-(-n // bm)) < density
    mask = np.repeat(runs, bm)[:n] & (rng.random(n) < max(density, 0.5))
    cols = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(V)]
    _check(mask, cols)


def test_pack_matches_stream():
    """A truncated output (n_out < n) keeps the first n_out hits."""
    rng = np.random.default_rng(11)
    n = 150000
    mask = rng.random(n) < 0.6
    cols = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(4)]
    _check(mask, cols, n_out=n // 3)


def test_compact_stream_matches_compact_by_mask():
    """Columns of other integer dtypes are compacted as uint32 bits."""
    rng = np.random.default_rng(9)
    n = 30000
    mask = rng.random(n) < 0.4
    cols = [rng.integers(-2**31, 2**31, n, dtype=np.int32)]
    count, (out,) = compact_by_mask(jnp.asarray(mask),
                                    (jnp.asarray(cols[0]),))
    assert int(count) == int(mask.sum())
    np.testing.assert_array_equal(
        np.asarray(out)[: int(count)], cols[0][mask].view(np.uint32))
