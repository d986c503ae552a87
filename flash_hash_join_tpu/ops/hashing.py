"""Vectorized hashing of u64 keys held as (hi, lo) uint32 pairs.

The reference hashes with the SSE4.2 CRC32 instruction plus an odd-constant
multiply (hash_join.cpp:40-44).  Vector units have no CRC32 instruction
and parity does not require the same hash (inner-join counts are hash-independent), so
we use a murmur3-style multiply-xorshift finalizer over the two 32-bit
halves — pure elementwise integer ops, ~10 instructions per key, full avalanche.

All functions take/return jnp.uint32 arrays and are shape-polymorphic.
"""

from __future__ import annotations

import jax.numpy as jnp

# Plain ints, cast at use: creating jnp scalars at module scope would
# initialize a JAX backend as a side effect of `import flash_hash_join_tpu`.
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN_INT = 0x9E3779B9


def fmix32(h: jnp.ndarray) -> jnp.ndarray:
    """murmur3 32-bit finalizer (public-domain constants)."""
    h = h.astype(jnp.uint32)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(_C1)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(_C2)
    h = h ^ (h >> 16)
    return h


def hash_u64(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    """32-bit hash of a u64 (hi, lo) pair with good top-bit avalanche.

    Top bits are the ones that matter: the home group is taken from the top
    (hash >> (32 - group_bits)), mirroring the reference's top-byte radix
    split (get_partition_idx = hash >> 56, hash_join.cpp:209) so that device
    partition ids, radix partition ids, and home groups nest by construction.
    """
    h = fmix32(lo.astype(jnp.uint32))
    h = fmix32(h ^ (hi.astype(jnp.uint32) * jnp.uint32(_GOLDEN_INT)))
    return h


def bloom_word(h: jnp.ndarray, k: int) -> jnp.ndarray:
    """Per-key bloom signature: k bits set in a 32-bit word.

    Plays the role of the reference's constexpr 16-bit tag table
    (hash_join.cpp:60-74) but is computed in-register from a secondary mix of
    the hash instead of a table lookup.
    """
    g = h * jnp.uint32(_GOLDEN_INT) + jnp.uint32(1)
    word = jnp.zeros_like(h)
    for i in range(k):
        bit = (g >> jnp.uint32(5 * i)) & jnp.uint32(31)
        word = word | (jnp.uint32(1) << bit)
    return word
