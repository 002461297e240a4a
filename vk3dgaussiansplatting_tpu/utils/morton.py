"""Morton / Z-order curve encoding.

Equivalent of the reference's `SMath::encodeZorderCurve`
(Engine/SMath.h:10-34): 10 bits per component spread to a 30-bit key, used to
sort gaussians for memory coherence at scene load (ResourceManager.cpp:283-297).

Implemented vectorized over numpy arrays (host-side, runs once at load) rather
than per-element as in the reference.
"""

from __future__ import annotations

import numpy as np


def _part_by_2(x: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of each element to every third bit."""
    x = x.astype(np.uint32) & np.uint32(0x000003FF)
    x = (x ^ (x << 16)) & np.uint32(0xFF0000FF)
    x = (x ^ (x << 8)) & np.uint32(0x0300F00F)
    x = (x ^ (x << 4)) & np.uint32(0x030C30C3)
    x = (x ^ (x << 2)) & np.uint32(0x09249249)
    return x


def encode_zorder(pos: np.ndarray) -> np.ndarray:
    """Encode integer [N,3] grid positions (each < 1024) to 30-bit Morton keys.

    Matches SMath::encodeZorderCurve (SMath.h:24-34):
    key = (part(z) << 2) + (part(y) << 1) + part(x).
    """
    pos = np.asarray(pos)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"expected [N,3] positions, got {pos.shape}")
    if (pos < 0).any() or (pos >= 1024).any():
        raise ValueError("morton components must be in [0, 1024)")
    return (
        (_part_by_2(pos[:, 2]) << 2)
        + (_part_by_2(pos[:, 1]) << 1)
        + _part_by_2(pos[:, 0])
    )


def morton_order(positions: np.ndarray) -> np.ndarray:
    """Return the permutation sorting gaussians along the Z-order curve.

    Reproduces ResourceManager.cpp:283-297: positions are min/max normalized
    into a 1023^3 grid (float32 math, truncating float->uint conversion) and
    sorted by Morton key.  `np.argsort(..., kind="stable")` gives the
    deterministic equivalent of the reference's std::sort on equal keys
    (std::sort is unstable; ties are documented as tolerance here).
    """
    positions = np.asarray(positions, dtype=np.float32)
    min_pos = positions.min(axis=0)
    max_pos = positions.max(axis=0)
    delta = max_pos - min_pos
    # Avoid division by zero on degenerate axes (all points coplanar).
    delta = np.where(delta == 0.0, np.float32(1.0), delta)
    morton_size = np.float32((1 << 10) - 1)
    grid = ((positions - min_pos) / delta * morton_size).astype(np.uint32)
    grid = np.minimum(grid, np.uint32(1023))
    keys = encode_zorder(grid)
    return np.argsort(keys, kind="stable")
