"""Sort-key generation — the InitSortList pass.

The reference kernel (InitSortList.comp) runs one thread per gaussian: cull,
compute the depth key and 2D covariance, evaluate SH color, then *atomically*
allocate one sort element per overlapped tile (`atomicAdd` on a global
counter, InitSortList.comp:131) and write `{tileKey, depthKey, gaussianIdx}`.

XLA has no dynamic output shapes, so the allocation is re-derived as a
deterministic prefix-sum plan:

  1. per-gaussian overlap counts  c_i = w_i * h_i   (0 if culled)
  2. exclusive scan               off_i = sum_{k<i} c_k
  3. fixed-capacity expansion     slot e in [0, E) belongs to gaussian
                                  g(e) = repeat(arange(N), counts)[e]

The reference *already* pads to a static capacity
`ceilPow2(numGaussians + 64*16*numTiles)` (Renderer.cpp:725) and drops
elements beyond it (InitSortList.comp:143), so the masked-static formulation
is behaviour-faithful — including the overflow-drop rule (slots >= E are
truncated) and the 0xFFFFFFFF sentinel padding (Subrenderer.cpp:42-46).
Unlike the atomic version, slot order is deterministic: gaussians allocate in
index order, tiles within a gaussian in row-major order (the kernel's y/x
loop, InitSortList.comp:133-150).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import SENTINEL, RenderConfig
from ..render import project


class SortElements(NamedTuple):
    """Flat sort-element list, capacity E with sentinel padding.

    tile:  [E] uint32 tile key (SENTINEL for unused slots)
    depth: [E] uint32 depth key (SENTINEL for unused slots)
    index: [E] uint32 source gaussian index (SENTINEL for unused slots)
    count: []  uint32 number of live elements (== reference's
           cullData.numGaussiansToRender.x clamped to capacity)
    """

    tile: jax.Array
    depth: jax.Array
    index: jax.Array
    count: jax.Array


class GaussianFrameData(NamedTuple):
    """Per-gaussian frame intermediates (the reference's write-back of
    `color`/`covariance` into the gaussian buffer, InitSortList.comp:123-127,
    plus the screen position RenderGaussians recomputes per element).

    color_alpha: [N,4]  SH color rgb + opacity
    cov2d:       [N,3]  2D covariance (upper triangle)
    cov_inv:     [N,3]  inverse 2D covariance; alpha forced to 0 when the
                 determinant is 0 (RenderGaussians.comp:94-105)
    screen_pos:  [N,2]  pixel-space position
    """

    color_alpha: jax.Array
    cov2d: jax.Array
    cov_inv: jax.Array
    screen_pos: jax.Array


def cull_mask(pos_view, ndc, config: RenderConfig):
    """Near-plane + NDC-margin culling (InitSortList.comp:92-101)."""
    near_ok = -pos_view[:, 2] > jnp.float32(config.near_plane)
    lim = jnp.float32(config.culling_ndc_limit)
    ndc_ok = (jnp.abs(ndc[:, 0]) <= lim) & (jnp.abs(ndc[:, 1]) <= lim)
    return near_ok & ndc_ok


def expand_rows(packed, counts, capacity: int):
    """Row i of packed [N, C] repeated counts[i] times, truncated or padded
    to `capacity` rows (jnp.repeat: a cumsum, a scatter of row starts and
    one row gather).  Slots past sum(counts) hold unspecified rows."""
    return jnp.repeat(packed, counts, axis=0, total_repeat_length=capacity)


def generate_sort_elements(
    table,
    view,
    proj,
    cam_pos,
    config: RenderConfig,
    capacity: int,
):
    """Full InitSortList pass over the gaussian table.

    Args:
      table: GaussianTable of device arrays.
      view/proj: [4,4] float32 row-major camera matrices.
      cam_pos: [3] float32 camera world position.
      config: static render config (trace-time constants, the push-constant/
        spec-constant equivalent).
      capacity: static sort-element capacity E.

    Returns (SortElements, GaussianFrameData).
    """
    pos = table.position
    n = pos.shape[0]

    pos_view = project.view_transform(pos, view)
    ndc = project.ndc_position(pos_view, proj)
    visible = cull_mask(pos_view, ndc, config)
    depth = project.depth_key(pos_view[:, 2], config)
    cov2d = project.compute_cov2d(
        table.scale, table.rot, pos_view, view, config
    )
    screen_pos = project.screen_space_position(pos_view, proj, config)
    extents = project.tile_extents(screen_pos, cov2d, config)

    # SH color (InitSortList.comp:122-126). The direction normalize produces
    # NaN for a gaussian exactly at the camera position; such gaussians are
    # behind the near plane and culled, but the reference would still write
    # NaN color. We keep the color NaN-free via the cull mask for safety.
    to_gauss = project.normalize_dirs(pos - cam_pos[None, :])
    rgb = project.sh_color(to_gauss, table.sh, config.sh_mode)
    color_alpha = jnp.concatenate([rgb, table.opacity[:, None]], axis=-1)

    # Inverse 2D covariance (RenderGaussians.comp:94-105): zero determinant
    # zeroes the alpha instead.
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    det_ok = det != jnp.float32(0.0)
    det_inv = jnp.where(det_ok, jnp.float32(1.0) / det, jnp.float32(0.0))
    cov_inv = (
        jnp.stack([cov2d[:, 2], -cov2d[:, 1], cov2d[:, 0]], axis=-1)
        * det_inv[:, None]
    )
    color_alpha = jnp.concatenate(
        [
            color_alpha[:, :3],
            jnp.where(det_ok[:, None], color_alpha[:, 3:4], jnp.float32(0.0)),
        ],
        axis=1,
    )

    # --- element allocation (scan replaces atomicAdd) ---------------------
    w = extents[:, 2] - extents[:, 0]
    h = extents[:, 3] - extents[:, 1]
    counts = jnp.where(visible, w * h, 0).astype(jnp.int32)
    cum = jnp.cumsum(counts)
    total = cum[-1] if n > 0 else jnp.int32(0)
    offsets = cum - counts  # exclusive

    # Fixed-capacity expansion: slot -> gaussian id.  Truncation at capacity
    # is the reference's overflow-drop rule; padded tail slots are masked
    # below.  Every per-slot value, the gaussian id included, rides ONE
    # row gather inside jnp.repeat as a column of a packed [N, 6] row.
    slot = jnp.arange(capacity, dtype=jnp.int32)
    live = slot < jnp.minimum(total, capacity)
    packed = jnp.stack(
        [
            jnp.arange(n, dtype=jnp.int32),
            offsets,
            jnp.maximum(w, 1),
            extents[:, 0],
            extents[:, 1],
            # u32 depth keys ride as their i32 bit pattern.
            jax.lax.bitcast_convert_type(depth, jnp.int32),
        ],
        axis=-1,
    )
    g = expand_rows(packed, counts, capacity)
    cols = [g[:, k] for k in range(packed.shape[1])]
    gauss_of_slot = cols[0]
    local = slot - cols[1]
    # Dead slots are masked below; keep their division defined.
    gw_safe = jnp.maximum(cols[2], 1)
    # Row-major within the gaussian's tile rect (InitSortList.comp:133-150).
    ly = local // gw_safe
    lx = local - ly * gw_safe
    tile_x = cols[3] + lx
    tile_y = cols[4] + ly
    tile_key = (tile_y * jnp.int32(config.grid_width) + tile_x).astype(jnp.uint32)

    sent = jnp.uint32(SENTINEL)
    elements = SortElements(
        tile=jnp.where(live, tile_key, sent),
        depth=jnp.where(
            live, jax.lax.bitcast_convert_type(cols[5], jnp.uint32), sent
        ),
        index=jnp.where(live, gauss_of_slot.astype(jnp.uint32), sent),
        count=jnp.minimum(total, capacity).astype(jnp.uint32),
    )
    frame = GaussianFrameData(
        color_alpha=color_alpha,
        cov2d=cov2d,
        cov_inv=cov_inv,
        screen_pos=screen_pos,
    )
    return elements, frame
