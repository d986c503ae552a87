"""Engine configuration.

The reference hard-codes its tuning constants as C++ ``constexpr``s
(RADIX_BITS=8 at hash_join.cpp:38, PROBE_BATCH_SIZE=2048 at :302,
SMALL_TABLE_THRESHOLD=500'000 at :393, RADIX_JOIN_THRESHOLD=1'000'000 at :576,
capacity growth 1.5x at :99).  Here they live in one dataclass so the adaptive
dispatcher (models/cost.py) can reason about them and tests can shrink them.
"""

from __future__ import annotations

import dataclasses


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """Static tuning knobs for the join engine.

    Attributes:
      group_size: slots per hash-table bucket group.  A group is stored as one
        contiguous row of ``2*group_size`` uint32 words (hi halves then lo
        halves), i.e. 64 bytes at the default of 8 — two 32-byte memory
        sectors per probe touch.  Plays the role of the reference's cache-line blocking.
      growth: slots-per-build-row factor.  2.0 => load factor 0.5 (the
        reference uses 1.5x rounded to pow2, ~load 2/3; we run slightly
        sparser because our probe cost is per *group* touched, not per slot).
      overflow_groups: extra groups appended past the power-of-two home range
        so linear-probe chains never wrap (the scatter clamps; see
        ops/hash_table.py).  Chains longer than this are dropped like the
        reference drops inserts into a full table (hash_join.cpp:149).
      probe_chunk: probe keys processed per pipeline step.  Bounds the
        (chunk, 2*group_size) gather window held in device memory — the
        analog of the reference's PROBE_BATCH_SIZE=2048 morsels.
      max_probe_iters: hard bound on the chain-walk while_loop.
      bloom_k: number of bits set per key in the per-group bloom word.
      min_groups: floor on the home-group count (keeps tiny builds sane).
    """

    group_size: int = 8
    growth: float = 2.0
    overflow_groups: int = 64
    probe_chunk: int = 1 << 20
    max_probe_iters: int = 256
    bloom_k: int = 3
    min_groups: int = 16

    def num_home_groups(self, n_build: int) -> int:
        """Power-of-two home-group count for a build side of n_build rows."""
        want_slots = max(int(n_build * self.growth), self.group_size)
        return max(next_pow2(-(-want_slots // self.group_size)), self.min_groups)

    def group_bits(self, n_build: int) -> int:
        return self.num_home_groups(n_build).bit_length() - 1

    def total_groups(self, n_build: int) -> int:
        return self.num_home_groups(n_build) + self.overflow_groups


DEFAULT_CONFIG = JoinConfig()
