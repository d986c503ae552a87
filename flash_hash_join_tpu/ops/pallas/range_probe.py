"""Pallas kernel (Triton route): the range table's binary search, fused.

The partitioned tier (ops/range_table.py) resolves each probe by a lower
bound over the sorted build key planes.  `range_table.search` writes that
search in plain jnp, where XLA runs it as a chain of whole-vector gather
passes; this kernel runs the same code with one program per block of
BLOCK probes: each program loads its probe tile once, keeps the search
state in registers through every power-of-two step (each step one gather
load from the table refs), and writes one int32 per probe — the first
table row holding the probe's key, or -1.

tests/test_range_table.py checks it against the plain search in
interpret mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from flash_hash_join_tpu.ops import range_table as rt

BLOCK = 1024


def _search_kernel(n_words: int, *refs):
    # indexing a table ref with the position vector is a gather load, so
    # the plain search runs unchanged on the refs
    probe = tuple(r[...] for r in refs[n_words:2 * n_words])
    refs[2 * n_words][...] = rt.search(refs[:n_words], probe)


@functools.partial(jax.jit, static_argnames=("interpret",))
def search(table_keys, probe_keys, *, interpret: bool = False):
    """Same contract as ops/range_table.search: first table row equal to
    each probe key (int32), -1 when absent."""
    n_table = table_keys[0].shape[0]
    m = probe_keys[0].shape[0]
    if n_table == 0:
        return jnp.full((m,), -1, jnp.int32)
    n_words = len(table_keys)
    mpad = -(-max(m, 1) // BLOCK) * BLOCK
    probe = tuple(jnp.pad(p, (0, mpad - m)) for p in probe_keys)
    tile = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    out = pl.pallas_call(
        functools.partial(_search_kernel, n_words),
        grid=(mpad // BLOCK,),
        in_specs=[whole] * n_words + [tile] * n_words,
        out_specs=tile,
        out_shape=jax.ShapeDtypeStruct((mpad,), jnp.int32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="range_search",
    )(*table_keys, *probe)
    return out[:m]
