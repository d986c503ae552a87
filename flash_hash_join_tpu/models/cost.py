"""Feasibility model: how many host-streamed probe chunks a join needs.

The reference dispatches on a single hard-coded row threshold
(`build_size < RADIX_JOIN_THRESHOLD` = 1e6, hash_join.cpp:576-594) and has
no capacity planning at all (a too-large probe side simply OOMs the host).
Here the strategy comes from the data (api.py: the dense-domain rule picks
"direct", everything else runs "partitioned"), and this module answers the
question the reference's morsel loop answers implicitly (hash_join.cpp:302,
:347 — bounded working set regardless of probe length): probe chunks are
streamed HOST-SIDE (api.py slices the numpy probe array and reruns the
per-chunk compiled graph), so the device never holds more than

    build planes + sorted table        FIXED_BYTES_PER_BUILD_ROW * nb
  + one chunk's input planes           8  B/chunk-row
  + one chunk's transients             TRANSIENT_BYTES_* B/chunk-row

`choose_plan` sizes the chunk so that total stays inside the device's
budget: `bytes_limit` of `memory_stats()` less HEADROOM_FRACTION.  The
per-row constants are the temp and output bytes XLA reports for the
partitioned graphs (`compiled.memory_analysis()`, printed per phase by
chip_smoke.py at 1e8 rows on an H100), rounded up.
"""

from __future__ import annotations

import dataclasses

import jax

from flash_hash_join_tpu.utils.config import JoinConfig

# Share of the device's bytes_limit left to XLA's own scratch, allocator
# fragmentation and arrays the caller holds beside the join.
HEADROOM_FRACTION = 0.2
# The CPU backend reports no memory statistics.  This constant stands in
# for it so that tests and CPU runs plan deterministically; no device
# measured it.
CPU_TEST_BUDGET_BYTES = 16 * 1024**3

# Device bytes per build row: the u32 key/value input planes (16 B) plus
# the sorted table the partitioned graph builds (keys, row index, values)
# and the sort's scratch.
FIXED_BYTES_PER_BUILD_ROW = 48
# Device bytes per probe row beyond its 8 input-plane bytes while a chunk
# is in flight.  memory_analysis() temp bytes of the partitioned graphs at
# db-benchmark J1 1e8 on an H100: count 9-14 B/probe row, materialize
# 10.3-11.3 B/probe row plus 16 B of output planes (chip_smoke.py j1
# phase); rounded up.
TRANSIENT_BYTES_COUNT = 16
TRANSIENT_BYTES_MATERIALIZE = 32


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    strategy: str       # "partitioned"; api.py upgrades dense domains
    gbits: int          # home-group bits for the global-table graph
    probe_chunks: int   # probe chunks that fit the device


def device_budget_bytes() -> int:
    """Working-set budget of one join on the default device."""
    dev = jax.devices()[0]
    stats = dev.memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"] * (1 - HEADROOM_FRACTION))
    if dev.platform != "cpu":
        raise RuntimeError(
            f"{dev.platform} device reports no bytes_limit in memory_stats();"
            " cannot size the join's working set")
    return CPU_TEST_BUDGET_BYTES


def table_bytes(n_build: int, cfg: JoinConfig) -> tuple[int, int]:
    """(keys-table bytes, bloom bytes) for the global-table strategy."""
    ntot = cfg.total_groups(n_build)
    per_group = 2 * cfg.group_size * 4  # uint32 hi+lo per slot
    return ntot * per_group, ntot * 4


def plan_probe_chunks(n_build: int, n_probe: int, mode: str,
                      budget_bytes: int | None = None) -> int:
    """Number of probe chunks the join must stream in.

    1 means single-shot (the common case).  Chunks stream from the host
    (api.py), so only the build side, its table, and ONE chunk are
    device-resident at a time — any probe length is feasible.
    """
    if budget_bytes is None:
        budget_bytes = device_budget_bytes()
    fixed = FIXED_BYTES_PER_BUILD_ROW * n_build
    per_row = 8 + (TRANSIENT_BYTES_MATERIALIZE if mode == "materialize"
                   else TRANSIENT_BYTES_COUNT)
    avail = budget_bytes - fixed
    if avail <= 0:
        raise MemoryError(
            f"build side of {n_build} rows alone exceeds the single-device "
            "budget; shard the build side with flash_hash_join_tpu.parallel "
            "instead")
    chunk_rows = avail // per_row
    if chunk_rows >= n_probe:
        return 1
    # Streaming runs a depth-2 pipeline (api.py _run_chunked): the NEXT
    # chunk's input planes (8 B/row) are device-resident while the current
    # chunk executes, so chunked plans budget for both.
    chunk_rows = avail // (per_row + 8)
    return -(-n_probe // max(chunk_rows, 1))


def choose_plan(n_build: int, n_probe: int, cfg: JoinConfig,
                mode: str = "count",
                budget_bytes: int | None = None) -> JoinPlan:
    """Pick chunking for a build/probe size pair.  probe_chunks > 1 makes
    api.py stream probe chunks host-side through the per-chunk compiled
    graph."""
    return JoinPlan(
        "partitioned",
        cfg.group_bits(n_build),
        plan_probe_chunks(n_build, n_probe, mode, budget_bytes),
    )
