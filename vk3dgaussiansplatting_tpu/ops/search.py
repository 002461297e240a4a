"""Two-level vectorized search over large sorted device arrays.

A flat `jnp.searchsorted` over an N-row array costs log2(N) (~24 at garden
scale) DEPENDENT gather rounds per probe set; on this stack each round pays
a fixed fused-loop latency, so the search is round-latency-bound (~0.2-0.3
ms/round -> 4-7 ms at garden scale) regardless of probe count.  Sorted data
admits a constant-depth formulation instead:

  1. coarse: position's chunk = #{chunks whose LAST value < probe} — one
     fused broadcast-compare reduce over the [num_chunks] last-values table
     (~N/1024 x P lane-ops, VPU-bound, no dependent rounds);
  2. fine: gather the single covering chunk's row [P, CHUNK] and count
     values < probe within it (sorted order makes exactly one chunk
     partial: chunks before it are wholly < probe, chunks after wholly >=).

Five fused ops total, ~0.5-1 ms at garden scale.  Exact by construction.

Used by ops/ranges.py (FindRanges).
"""

from __future__ import annotations

import jax.numpy as jnp

CHUNK = 1024  # coarse-level granularity


def two_level_left_search(arr, probes):
    """Vectorized `searchsorted(arr, probes, side="left")`, constant depth.

    arr:    [N] sorted array (any integer/uint dtype).
    probes: [P] probe values (same comparison domain as arr).
    Returns [P] int32 positions.  For integer keys, a side="right" search
    is `two_level_left_search(arr, probes + 1)` — but ONLY for probes
    strictly below the dtype maximum: probing the max (e.g. the 0xFFFFFFFF
    sentinel as uint32) wraps `probes + 1` to 0 and silently returns
    position 0 instead of the array end.  Callers deriving probes from data
    must clamp or saturate before applying the +1 recipe.
    """
    e = arr.shape[0]
    nc = -(-e // CHUNK)
    pad = nc * CHUNK - e
    # Pad with the dtype maximum so padding never counts as < probe.  (For
    # signed dtypes the max is still >= every probe by assumption: callers
    # probe values present in, or adjacent to, the array's value domain.)
    maxval = jnp.asarray(jnp.iinfo(arr.dtype).max, arr.dtype)
    arr_pad = jnp.concatenate([arr, jnp.full((pad,), maxval, arr.dtype)])
    mat = arr_pad.reshape(nc, CHUNK)
    lasts = mat[:, -1]

    # coarse: first chunk not wholly below the probe
    cstar = jnp.sum(
        (lasts[:, None] < probes[None, :]).astype(jnp.int32), axis=0
    )  # [P] in [0, nc]
    # fine: count within the covering chunk
    rows = jnp.take(mat, jnp.minimum(cstar, nc - 1), axis=0)  # [P, CHUNK]
    within = jnp.sum(
        (rows < probes[:, None]).astype(jnp.int32), axis=1
    )  # [P]
    pos = cstar * CHUNK + jnp.where(cstar >= nc, 0, within)
    return jnp.minimum(pos, e).astype(jnp.int32)
