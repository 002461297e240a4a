"""Bitonic merge sort tier — the reference's alternative GPU sort.

The reference selects between RadixSort and BitonicMergeSort at compile time
(`GPU_SORT_ALGORITHM`, Renderer.h:33).  Its bitonic path
(Sort/BitonicMergeSort.{h,cpp} + BitonicMergeSort.comp) runs LOCAL_BMS /
BIG_FLIP / BIG_DISPERSE / LOCAL_DISPERSE dispatches over a power-of-two
element buffer, comparing full 64-bit keys.

JAX formulation: the compare-exchange network is data-parallel over
the whole array, so each stage is a reshape + elementwise min/max on the
(tile, depth, index) triple, comparing lexicographically on the split 64-bit
key.  The stage schedule (k: block size doubling; j: distance halving —
"flip" then "disperse" phases) is identical to the reference's dispatch
schedule (BitonicMergeSort.cpp:103-149); the local-vs-global shared-memory
distinction disappears (XLA fuses stages into HBM-resident passes).

Requires a power-of-two capacity, like the reference (`assert` at
BitonicMergeSort.cpp:68) — guaranteed by the default capacity formula.

Note: bitonic compare-exchange is NOT stable, but (tile, depth) ties are
broken by comparing the gaussian index as a tertiary key, which yields
exactly the deterministic order of the stable radix/XLA tiers.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.config import RenderConfig
from .keygen import SortElements


def _key_less(t0, d0, i0, t1, d1, i1):
    """Lexicographic (tile, depth, index) comparison."""
    return (t0 < t1) | ((t0 == t1) & ((d0 < d1) | ((d0 == d1) & (i0 < i1))))


def sort_elements_bitonic(elements: SortElements) -> SortElements:
    tile, depth, index = elements.tile, elements.depth, elements.index
    e = tile.shape[0]
    if e & (e - 1):
        raise ValueError(
            f"bitonic sort requires a power-of-two capacity, got {e} "
            "(reference: BitonicMergeSort.cpp:68)"
        )

    k = 2
    while k <= e:
        # "Flip" phase: compare elements mirrored within each k-block
        # (BIG_FLIP / the flip step of LOCAL_BMS).
        def flip(arrs, k=k):
            t, d, i = arrs
            t2 = t.reshape(-1, k)
            d2 = d.reshape(-1, k)
            i2 = i.reshape(-1, k)
            tl, tr = t2[:, : k // 2], t2[:, k // 2 :][:, ::-1]
            dl, dr = d2[:, : k // 2], d2[:, k // 2 :][:, ::-1]
            il, ir = i2[:, : k // 2], i2[:, k // 2 :][:, ::-1]
            swap = ~_key_less(tl, dl, il, tr, dr, ir)
            ntl = jnp.where(swap, tr, tl)
            ntr = jnp.where(swap, tl, tr)
            ndl = jnp.where(swap, dr, dl)
            ndr = jnp.where(swap, dl, dr)
            nil = jnp.where(swap, ir, il)
            nir = jnp.where(swap, il, ir)
            t2 = jnp.concatenate([ntl, ntr[:, ::-1]], axis=1)
            d2 = jnp.concatenate([ndl, ndr[:, ::-1]], axis=1)
            i2 = jnp.concatenate([nil, nir[:, ::-1]], axis=1)
            return t2.reshape(-1), d2.reshape(-1), i2.reshape(-1)

        tile, depth, index = flip((tile, depth, index))

        # "Disperse" phases: distance-j compare-exchange, j halving
        # (BIG_DISPERSE / LOCAL_DISPERSE).
        # The mirrored flip is the distance-k/2 stage; remaining disperse
        # stages run distances k/4 ... 1.
        j = k // 4
        while j >= 1:
            def disperse(arrs, j=j):
                t, d, i = arrs
                t2 = t.reshape(-1, j)
                d2 = d.reshape(-1, j)
                i2 = i.reshape(-1, j)
                tl, tr = t2[0::2], t2[1::2]
                dl, dr = d2[0::2], d2[1::2]
                il, ir = i2[0::2], i2[1::2]
                swap = ~_key_less(tl, dl, il, tr, dr, ir)
                ntl = jnp.where(swap, tr, tl)
                ntr = jnp.where(swap, tl, tr)
                ndl = jnp.where(swap, dr, dl)
                ndr = jnp.where(swap, dl, dr)
                nil = jnp.where(swap, ir, il)
                nir = jnp.where(swap, il, ir)
                t3 = jnp.stack([ntl, ntr], axis=1).reshape(-1)
                d3 = jnp.stack([ndl, ndr], axis=1).reshape(-1)
                i3 = jnp.stack([nil, nir], axis=1).reshape(-1)
                return t3, d3, i3

            tile, depth, index = disperse((tile, depth, index))
            j //= 2
        k *= 2

    return SortElements(tile=tile, depth=depth, index=index, count=elements.count)
