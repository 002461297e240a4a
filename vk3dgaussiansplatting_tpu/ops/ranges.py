"""Per-tile range extraction — the FindRanges pass.

The reference kernel (FindRanges.comp) runs one thread per sorted element and
scatter-writes segment boundaries where neighbouring tile keys differ.  This
formulation inverts it: the sorted tile array is *searched per tile* — `start[t] = searchsorted(tiles, t, left)`,
`end[t] = searchsorted(tiles, t, right)` — num_tiles probes of log2(E) steps,
microseconds of work, no scatter.

Faithful quirks reproduced (see the oracle and FindRanges.comp:44-70):
  * tiles with no elements report (0, 0) — the reference's cleared buffer
    (Subrenderer.cpp:54-60) — rather than (s, s) insertion points;
  * the final slot only ever writes `end = E-1`: when slot E-1 is live its
    tile's end is clamped to E-1 (dropping that element), and when the E-2/
    E-1 boundary is a real tile change neither `end[tile[E-2]]` nor
    `start[tile[E-1]]` is written (they stay 0) because no thread examines
    that boundary.  Benign under sentinel padding; reproduced exactly for a
    completely full sort list.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.config import SENTINEL, RenderConfig
from .keygen import SortElements


from .search import two_level_left_search


def find_ranges(elements: SortElements, num_tiles: int):
    """Compute [num_tiles, 2] uint32 (start, end) ranges from sorted tiles."""
    tile = elements.tile
    e = tile.shape[0]
    tids = jnp.arange(num_tiles, dtype=jnp.uint32)

    # One probe set covers both sides: the keys are integers, so
    # searchsorted(t, "right") == searchsorted(t + 1, "left"); probing
    # 0..num_tiles once yields starts = ext[:-1] and ends = ext[1:].
    probes = jnp.arange(num_tiles + 1, dtype=jnp.uint32)
    ext = two_level_left_search(tile, probes)
    starts = ext[:num_tiles].astype(jnp.uint32)
    ends = ext[1:].astype(jnp.uint32)
    empty = starts == ends
    starts = jnp.where(empty, 0, starts)
    ends = jnp.where(empty, 0, ends)

    if e >= 2:
        last = tile[e - 1]
        prev = tile[e - 2]
        sent = jnp.uint32(SENTINEL)
        last_live = last != sent
        # Reference: slot E-1 only writes end = E-1 for its own tile.
        ends = jnp.where(last_live & (tids == last), jnp.uint32(e - 1), ends)
        # The E-2/E-1 boundary is never examined: with a real tile change
        # there, tile[E-2]'s end and tile[E-1]'s start are never written.
        boundary = last_live & (prev != last)
        ends = jnp.where(boundary & (tids == prev) & (prev != sent), 0, ends)
        starts = jnp.where(boundary & (tids == last), 0, starts)

    return jnp.stack([starts, ends], axis=-1)
