"""Join engine: jitted end-to-end build+probe graphs with AOT compile caching.

Maps the reference's driver layer (_hash_join_{scalar,radix}_{count,
materialize}, hash_join.cpp:316-567) onto single jitted XLA programs, one
per (shape, strategy, mode) signature — compiled once, cached, so the timed
call measures pure device execution (the analog of the reference's
SimpleTimer starting after pybind marshaling, hash_join.cpp:45-55, :390).

Strategies (api.py routes "adaptive"; models/cost.py sizes probe chunks):
  merge   — gather-free sort-merge join (ops/merge_join.py); the always-
            exact fallback (no quota/window failure modes).
  global  — bucketized hash table in device memory (ops/hash_table.py).
  partitioned — the reference's radix regime (hash_join.cpp:316-381,
            :498-534): sorted range table + per-probe binary search
            (ops/range_table.py).  Default for sparse or wide keys.
  direct  — dense-domain direct addressing (ops/direct_bitmap.py).
            Default when the build keys form a dense 32-bit domain.

Every count graph returns (count, special4); materialize graphs return
(count, out_kh, out_kl, out_vh, out_vl, special4).  special[3] != 0 means
the strategy dropped keys (bucket overflow, out-of-domain rows) — the
caller MUST fall back to an exact strategy (api.py reruns with merge), so
results are always exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from flash_hash_join_tpu.ops import hash_table as ht
from flash_hash_join_tpu.ops import merge_join as mj
from flash_hash_join_tpu.ops import range_table as rt
from flash_hash_join_tpu.utils.config import JoinConfig, DEFAULT_CONFIG
from flash_hash_join_tpu.models.cost import choose_plan

_ZERO4 = lambda: jnp.zeros((4,), jnp.uint32)  # noqa: E731


def _table_static(cfg: JoinConfig, gbits: int, use_bloom: bool) -> dict:
    return dict(
        group_size=cfg.group_size,
        total_groups=(1 << gbits) + cfg.overflow_groups,
        use_bloom=use_bloom,
        bloom_k=cfg.bloom_k,
        max_iters=cfg.max_probe_iters,
    )


def join_count_graph(kh, kl, vh, vl, ph, pl, nb_valid, np_valid, *,
                     cfg, gbits, use_bloom):
    table = ht.build_table(
        kh, kl, vh, vl, nb_valid, gbits=gbits, group_size=cfg.group_size,
        overflow_groups=cfg.overflow_groups, with_bloom=use_bloom,
        bloom_k=cfg.bloom_k, max_probe_iters=cfg.max_probe_iters)
    count = ht.probe_count(
        table, ph, pl, np_valid, probe_chunk=cfg.probe_chunk, gbits=gbits,
        **_table_static(cfg, gbits, use_bloom))
    return count, table.special


def join_materialize_graph(kh, kl, vh, vl, ph, pl, nb_valid, np_valid, *,
                           cfg, gbits, use_bloom):
    table = ht.build_table(
        kh, kl, vh, vl, nb_valid, gbits=gbits, group_size=cfg.group_size,
        overflow_groups=cfg.overflow_groups, with_bloom=use_bloom,
        bloom_k=cfg.bloom_k, max_probe_iters=cfg.max_probe_iters)
    out = ht.probe_materialize(
        table, ph, pl, np_valid, probe_chunk=cfg.probe_chunk, gbits=gbits,
        **_table_static(cfg, gbits, use_bloom))
    return (*out, table.special)


def merge_count_graph(*args):
    return mj.merge_join_count(*args), _ZERO4()


def merge_materialize_graph(*args):
    return (*mj.merge_join_materialize(*args), _ZERO4())


def direct_count_graph(kh, kl, vh, vl, ph, pl, nb_valid, np_valid, *,
                       d_rows):
    from flash_hash_join_tpu.ops import direct_bitmap as db
    return db.direct_join_count(kh, kl, ph, pl, nb_valid, np_valid,
                                d_rows=d_rows)


def direct_materialize_graph(kh, kl, vh, vl, ph, pl, nb_valid, np_valid, *,
                             v_rows, narrow_values):
    from flash_hash_join_tpu.ops import direct_bitmap as db
    return db.direct_join_materialize(
        kh, kl, vh, vl, ph, pl, nb_valid, np_valid, v_rows=v_rows,
        narrow_values=narrow_values)


STRATEGIES = ("global", "partitioned", "merge", "direct")


def _graph_fn(n_build: int, n_probe: int, mode: str, strategy: str,
              use_bloom: bool, cfg: JoinConfig, gbits: int,
              narrow: bool = False, narrow_values: bool = False,
              d_rows: int = 0):
    """The uncompiled join graph for a shape/config signature."""
    if strategy == "direct":
        # dense-domain direct addressing (ops/direct_bitmap.py).  The
        # d_rows arg is the compile RUNG: bitmap rows (4096 slots each)
        # for count, row-plane rows (128 slots each) for materialize —
        # api.py sizes it with d_rows_for / v_rows_for respectively.
        if mode == "count":
            return functools.partial(direct_count_graph, d_rows=d_rows)
        return functools.partial(direct_materialize_graph, v_rows=d_rows,
                                 narrow_values=narrow_values)
    if strategy == "merge":
        return merge_count_graph if mode == "count" else \
            merge_materialize_graph
    if strategy == "partitioned":
        # narrow: 32-bit keys; narrow_values drops the value-hi plane.
        # Both checked host-side by the caller (api.py).  Probe sides
        # larger than the device are streamed host-side (api.py chunk
        # loop per models/cost.py), so every graph here is single-shot.
        if mode == "count":
            return functools.partial(rt.range_join_count, narrow=narrow)
        return functools.partial(rt.range_join_materialize, narrow=narrow,
                                 narrow_values=narrow_values)
    if strategy == "global":
        graph = join_count_graph if mode == "count" else \
            join_materialize_graph
        return functools.partial(graph, cfg=cfg, gbits=gbits,
                                 use_bloom=use_bloom)
    raise ValueError(f"unknown strategy {strategy!r}; expected 'adaptive' "
                     f"or one of {STRATEGIES}")


def _aot(fn, n_build: int, n_probe: int):
    u32 = jnp.uint32
    i32 = jnp.int32
    spec = lambda n: jax.ShapeDtypeStruct((n,), u32)  # noqa: E731
    sc = jax.ShapeDtypeStruct((), i32)
    return (
        jax.jit(fn)
        .lower(spec(n_build), spec(n_build), spec(n_build), spec(n_build),
               spec(n_probe), spec(n_probe), sc, sc)
        .compile()
    )


@functools.lru_cache(maxsize=256)
def _compiled(n_build: int, n_probe: int, mode: str, strategy: str,
              use_bloom: bool, cfg: JoinConfig, gbits: int,
              narrow: bool = False, narrow_values: bool = False,
              d_rows: int = 0):
    """AOT-compile the join graph for a shape/config signature."""
    return _aot(_graph_fn(n_build, n_probe, mode, strategy, use_bloom, cfg,
                          gbits, narrow, narrow_values, d_rows),
                n_build, n_probe)


@functools.lru_cache(maxsize=64)
def _compiled_chained(n_build: int, n_probe: int, mode: str, strategy: str,
                      use_bloom: bool, cfg: JoinConfig, gbits: int,
                      narrow: bool, narrow_values: bool, reps: int,
                      d_rows: int = 0):
    """`reps` joins chained inside one scan, each on key-remixed inputs.

    Used for steady-state device timing: per-join device seconds =
    (t_chained - t_single)/(reps - 1), which cancels the flat per-call
    cost of dispatch, argument handling and result fetch, so the number
    is the device's own time per join.

    The remix adds a per-step constant to the u64 keys of BOTH sides
    (carry-propagated add, a key-space bijection) so the match structure —
    and therefore the count — is invariant and assertable, while XLA can
    neither CSE steps against each other nor hoist the sorts out of the
    scan.  Returns (count_sum, special3_sum, fold) — fold consumes
    materialize outputs so XLA cannot prune the output-writing work.
    """
    fn = _graph_fn(n_build, n_probe, mode, strategy, use_bloom, cfg, gbits,
                   narrow, narrow_values, d_rows)

    def chained(kh, kl, vh, vl, ph, pl, nb, npv):
        def step(carry, i):
            r = (i + jnp.uint32(1)) * jnp.uint32(0x9E3779B1)
            if strategy == "direct":
                # the bitmap graph needs the remix to preserve the dense
                # lo-relative domain: a 30-bit shift (no hi carry for keys
                # < 3*2^30) keeps the span intact; if a key DOES wrap, the
                # graph's span check raises special[3] and the caller
                # falls back to single-call timing
                r = r & jnp.uint32(0x3FFFFFFF)
                out = fn(kh, kl + r, vh, vl, ph, pl + r, nb, npv)
                cnt = out[0].astype(jnp.int32)
                spec = out[-1][3].astype(jnp.int32)
                fold = jnp.uint32(0)
                if mode == "materialize":
                    fold = jnp.sum(out[1] ^ out[2] ^ out[3] ^ out[4],
                                   dtype=jnp.uint32)
                c_acc, s_acc, f_acc = carry
                return (c_acc + cnt, s_acc + spec, f_acc ^ fold), None
            lo_b = kl + r
            hi_b = kh + (lo_b < kl).astype(jnp.uint32)
            lo_p = pl + r
            hi_p = ph + (lo_p < pl).astype(jnp.uint32)
            out = fn(hi_b, lo_b, vh, vl, hi_p, lo_p, nb, npv)
            cnt = out[0].astype(jnp.int32)
            spec = out[-1][3].astype(jnp.int32)
            fold = jnp.uint32(0)
            if mode == "materialize":
                # consume every output plane so XLA cannot prune the
                # output-writing work (wrapping u32 sum; not asserted on)
                fold = jnp.sum(out[1] ^ out[2] ^ out[3] ^ out[4],
                               dtype=jnp.uint32)
            c_acc, s_acc, f_acc = carry
            return (c_acc + cnt, s_acc + spec, f_acc ^ fold), None

        init = (jnp.int32(0), jnp.int32(0), jnp.uint32(0))
        (c, s, f), _ = jax.lax.scan(
            step, init, jnp.arange(reps, dtype=jnp.uint32))
        return c, s, f

    return _aot(chained, n_build, n_probe)


class JoinEngine:
    """Host-side orchestration: packing, planning, compile cache, timing."""

    def __init__(self, cfg: JoinConfig | None = None):
        self.cfg = cfg or DEFAULT_CONFIG

    def plan(self, n_build: int, n_probe: int, mode: str = "count"):
        return choose_plan(n_build, n_probe, self.cfg, mode)

    def prepare(self, n_build, n_probe, mode, strategy, use_bloom,
                gbits=None, narrow=False, narrow_values=False, d_rows=0):
        if gbits is None:
            gbits = self.cfg.group_bits(n_build)
        return _compiled(
            n_build, n_probe, mode, strategy,
            # bloom only changes the global-strategy graph; normalize the
            # cache key so `_bloom` aliases reuse the identical compiled
            # program instead of paying a second compile
            use_bloom and strategy == "global", self.cfg, gbits,
            narrow and strategy == "partitioned",
            narrow_values and mode == "materialize",
            d_rows if strategy == "direct" else 0,
        )

    def prepare_chained(self, n_build, n_probe, mode, strategy, use_bloom,
                        reps, gbits=None, narrow=False, narrow_values=False,
                        d_rows=0):
        if gbits is None:
            gbits = self.cfg.group_bits(n_build)
        return _compiled_chained(
            n_build, n_probe, mode, strategy,
            use_bloom and strategy == "global", self.cfg, gbits,
            narrow and strategy == "partitioned",
            narrow_values and mode == "materialize", reps,
            d_rows if strategy == "direct" else 0)

    def run(self, compiled, device_args):
        out = compiled(*device_args)
        return jax.tree_util.tree_map(lambda x: x.block_until_ready(), out)


_DEFAULT_ENGINE = JoinEngine()


def default_engine() -> JoinEngine:
    return _DEFAULT_ENGINE
