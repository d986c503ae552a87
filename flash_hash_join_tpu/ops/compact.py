"""Stream compaction of matched rows — shared by every materialize path.

Stable exact-offset compaction: an exclusive prefix sum of the mask gives
each kept row its output slot, and one row scatter moves all payload
columns at once.  Kept rows land at the front in their original relative
order (deterministic); the tail is zero.
"""

from __future__ import annotations

import jax.numpy as jnp


def compact_by_mask(mask, cols, n_out: int | None = None):
    """Return (count, cols') with rows where mask is True moved, in input
    order, to the front of each column.  Rows past `count` are zero.

    cols: uint32 arrays of mask's length; n_out: optional truncation.
    """
    n = mask.shape[0]
    n_out = n if n_out is None else n_out
    keep = mask.astype(jnp.int32)
    slot = jnp.cumsum(keep) - keep
    # dropped rows (and kept rows past n_out) target slot n_out: out of
    # bounds, so mode="drop" discards them
    slot = jnp.where(mask & (slot < n_out), slot, n_out)
    stacked = jnp.stack([c.astype(jnp.uint32) for c in cols], axis=1)
    out = jnp.zeros((n_out, len(cols)), jnp.uint32).at[slot].set(
        stacked, mode="drop")
    return jnp.sum(keep), tuple(out[:, i] for i in range(len(cols)))
