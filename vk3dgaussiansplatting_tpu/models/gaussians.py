"""Gaussian scene model — structure-of-arrays pytree.

The reference stores gaussians as an array-of-structs `GaussianData`
(ShaderStructs.h:59-70: pos/scale/rot/shCoeffs[16]/color/covariance, 352 B).
Here the layout is a structure-of-arrays pytree: each attribute is a
contiguous `[N, ...]` array so every per-gaussian pass is a pure vectorized map
and XLA can lay fields out independently in device memory.

The mutable `color`/`covariance` fields the reference writes back from
InitSortList (InitSortList.comp:123-127) are *not* part of the model: in SSA
dataflow they are per-frame intermediates produced by `ops.keygen` and consumed
by `ops.blend`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np

from ..utils.morton import morton_order

NUM_SH_COEFFS = 16


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GaussianTable:
    """SoA table of N gaussians.

    Fields (all float32):
      position  [N, 3] — world position, x/y negated at load like the
                 reference (ResourceManager.cpp:231-236)
      scale     [N, 3] — exp-activated scales (ResourceManager.cpp:237-242)
      rot       [N, 4] — normalized, component-permuted quaternion
                 (-r2, -r3, r0, -r1) (ResourceManager.cpp:243-257)
      sh        [N, 16, 3] — SH coefficients, coeff-major (shCoeffs[c].xyz)
      opacity   [N]    — sigmoid-activated opacity (shCoeffs[0].a in the
                 reference layout, ResourceManager.cpp:263)
    """

    position: Any
    scale: Any
    rot: Any
    sh: Any
    opacity: Any

    @property
    def num_gaussians(self) -> int:
        return self.position.shape[0]

    def __len__(self) -> int:
        return self.num_gaussians

    def to_numpy(self) -> "GaussianTable":
        return GaussianTable(
            position=np.asarray(self.position),
            scale=np.asarray(self.scale),
            rot=np.asarray(self.rot),
            sh=np.asarray(self.sh),
            opacity=np.asarray(self.opacity),
        )

    def take(self, indices: np.ndarray) -> "GaussianTable":
        return GaussianTable(
            position=self.position[indices],
            scale=self.scale[indices],
            rot=self.rot[indices],
            sh=self.sh[indices],
            opacity=self.opacity[indices],
        )

    def concat(self, other: "GaussianTable") -> "GaussianTable":
        return GaussianTable(
            position=np.concatenate([self.position, other.position]),
            scale=np.concatenate([self.scale, other.scale]),
            rot=np.concatenate([self.rot, other.rot]),
            sh=np.concatenate([self.sh, other.sh]),
            opacity=np.concatenate([self.opacity, other.opacity]),
        )


def from_raw_ply_columns(
    *,
    xyz: np.ndarray,
    scales: np.ndarray,
    rots: np.ndarray,
    opacities: np.ndarray,
    f_dc: np.ndarray,
    f_rest: np.ndarray,
    morton_sort: bool = True,
) -> GaussianTable:
    """Apply the reference's load-time transforms to raw .ply columns.

    Reproduces ResourceManager::loadGaussians (ResourceManager.cpp:227-297):
      - position = (-x, -y, z)
      - scale = exp(scale_i)
      - rot = normalize(r0..r3) then permuted to (-r2, -r3, r0, -r1)
      - opacity = sigmoid(opacity)
      - sh[0] = f_dc; sh[1..15] = f_rest in *channel-major* order: property
        f_rest_{c + 15*ch} is coefficient c+1, channel ch
      - finally sorted along the Morton curve of min/max-normalized position

    Args:
      xyz:       [N,3] raw positions
      scales:    [N,3] raw log-scales
      rots:      [N,4] raw quaternion (r0..r3)
      opacities: [N]   raw logit opacities
      f_dc:      [N,3] DC SH coefficients
      f_rest:    [N,45] higher-order coefficients in ply property order
                 (f_rest_0..f_rest_44, channel-major)
    """
    n = xyz.shape[0]
    xyz = np.asarray(xyz, dtype=np.float32)
    position = np.stack([-xyz[:, 0], -xyz[:, 1], xyz[:, 2]], axis=1)
    scale = np.exp(np.asarray(scales, dtype=np.float32))

    rots = np.asarray(rots, dtype=np.float32)
    norm = np.sqrt((rots * rots).sum(axis=1, keepdims=True))
    rots = rots / norm
    rot = np.stack([-rots[:, 2], -rots[:, 3], rots[:, 0], -rots[:, 1]], axis=1)

    opacity = 1.0 / (1.0 + np.exp(-np.asarray(opacities, dtype=np.float32)))

    sh = np.zeros((n, NUM_SH_COEFFS, 3), dtype=np.float32)
    sh[:, 0, :] = np.asarray(f_dc, dtype=np.float32)
    f_rest = np.asarray(f_rest, dtype=np.float32)
    if f_rest.size:
        num_rest = 15
        # channel-major: f_rest[:, c + num_rest*ch] -> sh[:, c+1, ch]
        for ch in range(3):
            sh[:, 1 : 1 + num_rest, ch] = f_rest[:, num_rest * ch : num_rest * (ch + 1)]

    table = GaussianTable(
        position=position,
        scale=scale,
        rot=rot,
        sh=sh,
        opacity=opacity.astype(np.float32),
    )
    if morton_sort and n > 1:
        table = table.take(morton_order(position))
    return table


def raw_ply_columns_from_table(table: GaussianTable) -> dict:
    """Invert the reference's load-time transforms (from_raw_ply_columns):
    produce the raw .ply property columns whose load reproduces `table`
    (up to float32 exp/log and sigmoid/logit round-trips).

    Used to export procedural scenes as real capture-format .ply files so
    the full ResourceManager-equivalent load path (parser, activations,
    Morton sort — ResourceManager.cpp:167-300) can be exercised and
    benchmarked at scene scale.
    """
    pos = np.asarray(table.position, np.float32)
    xyz = np.stack([-pos[:, 0], -pos[:, 1], pos[:, 2]], axis=1)
    scales = np.log(np.maximum(np.asarray(table.scale, np.float32), 1e-30))
    r = np.asarray(table.rot, np.float32)
    # loaded (p,q,r,s) = (-c, -d, a, -b) of raw (a,b,c,d)  =>  raw =
    # (r, -s, -p, -q)
    rots = np.stack([r[:, 2], -r[:, 3], -r[:, 0], -r[:, 1]], axis=1)
    o = np.clip(np.asarray(table.opacity, np.float32), 1e-6, 1.0 - 1e-6)
    opacities = np.log(o / (1.0 - o)).astype(np.float32)
    sh = np.asarray(table.sh, np.float32)
    f_dc = sh[:, 0, :]
    num_rest = NUM_SH_COEFFS - 1
    f_rest = np.zeros((sh.shape[0], 3 * num_rest), np.float32)
    for ch in range(3):
        f_rest[:, num_rest * ch : num_rest * (ch + 1)] = sh[
            :, 1 : 1 + num_rest, ch
        ]
    return dict(
        xyz=xyz,
        scales=scales,
        rots=rots,
        opacities=opacities,
        f_dc=f_dc,
        f_rest=f_rest,
    )


def make_gaussian(
    position,
    scale=(1.0, 1.0, 1.0),
    rot=(1.0, 0.0, 0.0, 0.0),
    color_sh0=(0.0, 0.0, 0.0),
    opacity=1.0,
) -> GaussianTable:
    """Build a single already-activated gaussian (ResourceManager::addGaussian
    equivalent, ResourceManager.h:47 — bypasses the load-time transforms, used
    by the synthetic test scenes)."""
    sh = np.zeros((1, NUM_SH_COEFFS, 3), dtype=np.float32)
    sh[0, 0] = np.asarray(color_sh0, dtype=np.float32)
    return GaussianTable(
        position=np.asarray([position], dtype=np.float32),
        scale=np.asarray([scale], dtype=np.float32),
        rot=np.asarray([rot], dtype=np.float32),
        sh=sh,
        opacity=np.asarray([opacity], dtype=np.float32),
    )


def concat_tables(tables: list[GaussianTable]) -> GaussianTable:
    return GaussianTable(
        position=np.concatenate([t.position for t in tables]),
        scale=np.concatenate([t.scale for t in tables]),
        rot=np.concatenate([t.rot for t in tables]),
        sh=np.concatenate([t.sh for t in tables]),
        opacity=np.concatenate([t.opacity for t in tables]),
    )
