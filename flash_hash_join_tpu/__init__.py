"""flash_hash_join_tpu — a vectorized hash-join / query-execution engine
built from scratch in JAX/XLA, with the capabilities of the CPU reference
`conanhujinming/flash_hash_join` (see SURVEY.md).

Public API mirrors the reference pybind module's 13 functions
(hash_join.cpp:598-640): adaptive_join[_bloom][, _count[_bloom]],
hash_join[_bloom], hash_join_radix[_bloom], hash_join_count[...],
plus `initialize()`.  All take numpy uint64 (build_keys, build_values,
probe_keys) and return (count, core_seconds).
"""

import os as _os

import jax as _jax

# Persistent compilation cache: the engine AOT-compiles one XLA program per
# (shape, strategy, mode) signature (engine.py); caching them is the analog
# of the reference shipping a prebuilt .so.  JAX_COMPILATION_CACHE_DIR,
# when set, is JAX's own setting and wins; otherwise the cache lives at a
# fixed path inside the checkout (git-ignored), so repeated runs hit it.
CACHE_DIR = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from flash_hash_join_tpu.api import (  # noqa: F401
    adaptive_join,
    adaptive_join_bloom,
    adaptive_join_count,
    adaptive_join_count_bloom,
    hash_join,
    hash_join_bloom,
    hash_join_radix,
    hash_join_radix_bloom,
    hash_join_count,
    hash_join_count_bloom,
    hash_join_count_radix,
    hash_join_count_radix_bloom,
    initialize,
    join_count,
    join_materialize,
    distributed_join_count,
    distributed_join_materialize,
    measure_device_seconds,
    plan_strategy,
    bloom_is_distinct,
)

__version__ = "0.3.0"
