"""Sort-element ordering — the reference's GPU sort subsystem.

The reference sorts {tileKey, depthKey, gaussianIdx} triples by the 64-bit key
(tileKey << 32) | depthKey with a FidelityFX-style 4-bit LSD radix sort
(Engine/Graphics/Sort/RadixSort.cpp) or a bitonic merge sort
(BitonicMergeSort.cpp), selected by `GPU_SORT_ALGORITHM` (Renderer.h:33).

JAX has no u64 without x64 mode, so the key is kept as its two u32 words
(the reference's own shaders also handle it word-split,
RadixSortCount.comp:60-73).  Two tiers:

  * XLA_SORT — `jax.lax.sort` with the u16-tile / 3-key-unstable tricks
    (sort_elements_xla below) — the production tier on every backend, and
    the role-equivalent of the reference's RadixSort.  Whether an LSD radix
    over the used key bits (`radixSortNumSortBits = roundUp4(32 +
    minNumBits(numTiles-1))`, RadixSort.cpp:203-204) beats it on the GPU
    is open (ROADMAP S2).
  * BITONIC — the reference's alternative backend (ops/bitonic.py).

Sentinel slots (0xFFFFFFFF everywhere) sort to the end, exactly like the
reference's cleared-buffer padding (Subrenderer.cpp:42-46).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import RenderConfig, SortAlgorithm
from .keygen import SortElements


def sort_elements_xla(
    elements: SortElements, num_tiles: int | None = None
) -> SortElements:
    """Lexicographic sort by (tile, depth) via XLA's sort HLO, order-stable.

    Two tricks that move fewer bytes, both order-preserving (their cost on
    the GPU is open, ROADMAP S2):

    * When the tile-id range provably fits in 16 bits (every benchmark
      resolution: 8160 tiles at 1080p), the tile key is sorted as uint16.
      Live tiles are < 0xFFFF and the 0xFFFFFFFF sentinel maps to 0xFFFF,
      still the maximum.
    * The index column is promoted from payload to a THIRD sort key with
      `is_stable=False`.  The result is deterministically identical to the stable 2-key sort: within an
      equal (tile, depth) pair the gaussian ids are distinct (a gaussian
      emits at most one element per tile) and ascend with keygen slot
      order, so ordering ties by the id column reproduces stability; the
      all-equal sentinel ties are order-irrelevant.
    """
    if num_tiles is not None and num_tiles < 0xFFFF:
        tile16, depth, index = jax.lax.sort(
            (elements.tile.astype(jnp.uint16), elements.depth, elements.index),
            dimension=0,
            num_keys=3,
            is_stable=False,
        )
        from ..core.config import SENTINEL

        tile = jnp.where(
            tile16 == jnp.uint16(0xFFFF),
            jnp.uint32(SENTINEL),
            tile16.astype(jnp.uint32),
        )
    else:
        tile, depth, index = jax.lax.sort(
            (elements.tile, elements.depth, elements.index),
            dimension=0,
            num_keys=3,
            is_stable=False,
        )
    return SortElements(tile=tile, depth=depth, index=index, count=elements.count)


def sort_elements(
    elements: SortElements, config: RenderConfig
) -> SortElements:
    """Dispatch on the configured sort algorithm."""
    algo = config.sort_algorithm
    if algo in (SortAlgorithm.AUTO, SortAlgorithm.XLA_SORT):
        return sort_elements_xla(elements, num_tiles=config.num_tiles)
    if algo == SortAlgorithm.BITONIC:
        from .bitonic import sort_elements_bitonic

        return sort_elements_bitonic(elements)
    raise ValueError(f"unknown sort algorithm {algo}")
