"""uint64 <-> (hi, lo) uint32-pair packing.

JAX runs with 32-bit integers unless x64 mode is on, so the pair
representation is explicit and SoA: every u64 column travels through the
engine as two uint32 arrays.  The reference keeps native u64 scalars
(hash_join.cpp:40-44, numpy uint64 buffers at :385); here all comparisons
become two word compares ANDed (SURVEY.md §7).
"""

from __future__ import annotations

import numpy as np

# u64 sentinel 2**64-1 marks an empty slot; a *real* key with this value is
# never stored — it is handled exactly via the table's `special` side channel
# (see ops/hash_table.py), so the sentinel costs no correctness.
EMPTY32 = np.uint32(0xFFFFFFFF)


def split_u64(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a numpy uint64 array into (hi, lo) uint32 arrays (zero-copy view)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint64:
        arr = arr.astype(np.uint64)
    pairs = arr.view(np.uint32).reshape(-1, 2)
    # little-endian: word 0 is the low half.
    return np.ascontiguousarray(pairs[:, 1]), np.ascontiguousarray(pairs[:, 0])


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Combine (hi, lo) uint32 arrays back into a numpy uint64 array."""
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    out = np.empty(hi.shape + (2,), dtype=np.uint32)
    out[..., 0] = lo
    out[..., 1] = hi
    return out.view(np.uint64).reshape(hi.shape)
