"""Tiled front-to-back alpha blending — the RenderGaussians pass, XLA tier.

The reference kernel (RenderGaussians.comp) assigns a 16x16 thread group to
each screen tile and blends the tile's sorted element range front-to-back with
a sequential transmittance recurrence per pixel:

    eligible: f <= 0 and alpha >= 1/255         (:119-128)
    color += T * alpha * rgb                    (:131)
    T     *= (1 - alpha), stop when T < 1e-4    (:133-142)

This plain-XLA formulation exposes the parallelism the recurrence hides: the
transmittance before element j is a *product* over eligible earlier elements
of (1 - alpha), so

    T_excl(j, p) = exp( sum_{k<j, eligible} log1p(-alpha_k(p)) )

turns the per-pixel scan into a segmented cumulative sum, and the
early-termination flag becomes a pure mask: because T_excl is monotonically
non-increasing, "a previous element terminated this pixel" is exactly
`T_excl < 1e-4` (the terminating element itself still contributes, matching
the reference's order of color-update before the break).  The sum restarts
at every tile (a segmented scan), so its magnitude never exceeds one tile's
terms and f32 keeps the per-tile precision at any scene size.

Numerical contract (tests/test_pipeline.py): output images match the
sequential numpy oracle with an 8-bit tolerance of +-1.  log1p(-alpha) is
clamped to >= -87 so an alpha of exactly 1.0 (possible for synthetic
opacity-1 gaussians) yields T_excl -> 0 rather than -inf/NaN, observationally
identical to the reference's T = 0 termination.

Memory is O(E * 256): this is the CPU tier and the plain reference the GPU
tile-blend kernel (ops/pallas/blend_kernel.py) is checked against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import SENTINEL, RenderConfig
from .keygen import GaussianFrameData, SortElements

LOG_T_MIN = -87.0  # exp(-87) ~ 1.6e-38: flushes to +0 transmittance in f32


def gather_element_features(elements: SortElements, frame: GaussianFrameData):
    """Gather per-gaussian frame data into sorted-element order.

    The reference's render kernel chases `sortData[i].z -> gaussians[idx]`
    per element per tile (RenderGaussians.comp:92-95); the XLA tier hoists
    that into one gather.  Returns (screen_pos[E,2], color_alpha[E,4],
    cov_inv[E,3]).
    """
    idx = jnp.where(
        elements.index == jnp.uint32(SENTINEL), jnp.uint32(0), elements.index
    ).astype(jnp.int32)
    return (
        frame.screen_pos[idx],
        frame.color_alpha[idx],
        frame.cov_inv[idx],
    )


SCAN_CHUNK = 128  # rows per chunk of the two-level segmented cumsum


def _segmented_cumsum_chunk(x, seg_first):
    """Segmented inclusive cumsum along axis 0 of one chunk x [C, ...]
    (Hillis-Steele: log2(C) shifted adds that never cross a restart, so
    every partial sum stays inside one segment)."""
    c = x.shape[0]
    f = seg_first.reshape((c,) + (1,) * (x.ndim - 1))
    shift = 1
    while shift < c:
        x_prev = jnp.concatenate([jnp.zeros_like(x[:shift]), x[:-shift]])
        f_prev = jnp.concatenate([jnp.ones_like(f[:shift]), f[:-shift]])
        x = jnp.where(f, x, x + x_prev)
        f = f | f_prev
        shift *= 2
    return x


def segmented_cumsum(x, seg_first):
    """Inclusive cumsum of x [E, ...] along axis 0, restarting at every row
    where seg_first [E] is True.

    Two-level: a segmented scan inside each SCAN_CHUNK-row chunk, then the
    same function over the chunks' trailing sums carries segments across
    chunk boundaries.  Every partial sum stays inside one segment, so f32
    keeps per-segment precision however long the list is (a global cumsum
    rebased at segment starts cancels catastrophically at garden scale)."""
    e = x.shape[0]
    if e <= SCAN_CHUNK:
        return _segmented_cumsum_chunk(x, seg_first)
    nc = -(-e // SCAN_CHUNK)
    pad = nc * SCAN_CHUNK - e
    xp = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
    fp = jnp.concatenate([seg_first, jnp.ones((pad,), bool)])
    xc = xp.reshape((nc, SCAN_CHUNK) + x.shape[1:])
    fc = fp.reshape(nc, SCAN_CHUNK)
    local = jax.vmap(_segmented_cumsum_chunk)(xc, fc)
    # Segment sum reaching each chunk's end, carried across chunks that
    # hold no restart.
    reach = segmented_cumsum(local[:, -1], fc.any(axis=1))
    carry_in = jnp.concatenate([jnp.zeros_like(reach[:1]), reach[:-1]])
    before_restart = jnp.cumsum(fc, axis=1) == 0
    bshape = (nc, SCAN_CHUNK) + (1,) * (x.ndim - 1)
    out = local + jnp.where(
        before_restart.reshape(bshape), carry_in[:, None], 0.0
    )
    return out.reshape((nc * SCAN_CHUNK,) + x.shape[1:])[:e]


def _pixel_coords(config: RenderConfig):
    """Absolute pixel coordinates per (tile, in-tile pixel): [P] each for one
    tile given its base; returns in-tile (u, v) offsets of shape [P]."""
    ts = config.tile_size
    lv, lu = jnp.meshgrid(
        jnp.arange(ts, dtype=jnp.float32),
        jnp.arange(ts, dtype=jnp.float32),
        indexing="ij",
    )
    return lu.reshape(-1), lv.reshape(-1)  # [P], row-major v-major like GLSL


def blend_strip_colors_xla(
    elements: SortElements,
    ranges,
    frame: GaussianFrameData,
    config: RenderConfig,
    *,
    tile_base: int | jax.Array = 0,
    num_strip_tiles: int | None = None,
    carry_color=None,
    carry_logt=None,
    origin_y: int | jax.Array = 0,
    features=None,
):
    """Carry-aware blend core over tiles [tile_base, tile_base + T_s).

    Blends each strip tile's sorted element range with an optional incoming
    per-pixel transmittance/color carry — the primitive the distributed
    depth-banded pipeline chains across devices (each device blends one depth
    band of the tile; bands combine in depth order with the associative
    over-operator, SURVEY.md §5 "long-context" analogue).

    Args:
      elements/ranges/frame: the device's sorted elements, global-tile-id
        ranges [num_tiles, 2] and frame data.
      tile_base: first tile id of the target strip (element tile ids are
        global; pixel coordinates derive from the global id).
      num_strip_tiles: strip length T_s (static; default config.num_tiles).
      carry_color: [T_s, P, 3] accumulated color entering this band (or None).
      carry_logt: [T_s, P] accumulated log-transmittance entering this band
        (or None).  T_excl(j) = exp(carry_logt + sum of local log terms).
      origin_y: extra pixel-row offset for legacy strip-local callers.
      features: optional pre-gathered per-element
        (screen_pos [E,2], color_alpha [E,4], cov_inv [E,3]) — the routed
        form the distributed exchange ships instead of all-gathering the
        whole gaussian table (frame may then be None).

    Returns (colors [T_s, P, 3], logt_end [T_s, P]) — pre-clip accumulated
    color and the outgoing log-transmittance.
    """
    if features is None:
        screen_pos, color_alpha, cov_inv = gather_element_features(
            elements, frame
        )
    else:
        screen_pos, color_alpha, cov_inv = features
    tile = elements.tile
    e = tile.shape[0]
    p = config.tile_size * config.tile_size
    gw = config.grid_width
    t_s = config.num_tiles if num_strip_tiles is None else num_strip_tiles
    tile_base = jnp.asarray(tile_base, jnp.int32)

    live = tile != jnp.uint32(SENTINEL)
    tile_i = jnp.where(live, tile, 0).astype(jnp.int32)
    tile_loc = tile_i - tile_base  # strip-local index
    in_strip = live & (tile_loc >= 0) & (tile_loc < t_s)
    tile_loc_c = jnp.clip(tile_loc, 0, t_s - 1)
    tile_x = tile_i % gw
    tile_y = tile_i // gw

    lu, lv = _pixel_coords(config)  # [P]
    ts = jnp.float32(config.tile_size)
    u = tile_x[:, None].astype(jnp.float32) * ts + lu[None, :]  # [E,P]
    v = (
        tile_y[:, None].astype(jnp.float32) * ts
        + lv[None, :]
        + jnp.asarray(origin_y, jnp.float32)
    )

    gx = screen_pos[:, 0:1]
    gy = screen_pos[:, 1:2]
    a = cov_inv[:, 0:1]
    b = cov_inv[:, 1:2]
    c = cov_inv[:, 2:3]
    galpha = color_alpha[:, 3:4]

    # evalX = gScreenPos - pixel; evalX.y = -evalX.y (RenderGaussians.comp:117)
    dx = gx - u
    dy = v - gy
    f = (
        jnp.float32(-0.5) * (a * dx * dx + c * dy * dy)
        - b * dx * dy
    )
    alpha = galpha * jnp.exp(f)
    eligible = (
        (f <= jnp.float32(0.0))
        & (alpha >= jnp.float32(config.alpha_cutoff))
        & live[:, None]
    )

    # Elements outside the tile's [start, end) range contribute nothing (the
    # reference loop bounds); every live element lies in its tile's range
    # except the final-slot quirk (end = E-1).
    in_range = (
        jnp.arange(e, dtype=jnp.uint32)[:, None] < ranges[tile_i, 1][:, None]
    )
    log_term = jnp.where(
        eligible & in_range,
        jnp.maximum(jnp.log1p(-alpha), jnp.float32(LOG_T_MIN)),
        jnp.float32(0.0),
    )
    # Segmented inclusive cumsum, restarting at every tile change of the
    # sorted list; exclusive = inclusive - own term.
    seg_first = jnp.concatenate(
        [jnp.ones((1,), bool), tile[1:] != tile[:-1]]
    )
    cs_incl = segmented_cumsum(log_term, seg_first)
    log_t_excl = cs_incl - log_term
    if carry_logt is not None:
        log_t_excl = log_t_excl + carry_logt[tile_loc_c]
    t_excl = jnp.exp(log_t_excl)

    not_done = t_excl >= jnp.float32(config.transmittance_stop)
    w = jnp.where(
        eligible & not_done & in_range & in_strip[:, None],
        t_excl * alpha,
        jnp.float32(0.0),
    )

    contrib = w[:, :, None] * color_alpha[:, None, :3]  # [E,P,3]
    tile_tgt = jnp.where(in_strip, tile_loc_c, t_s)
    colors = jnp.zeros((t_s + 1, p, 3), dtype=jnp.float32).at[tile_tgt].add(
        contrib, mode="drop"
    )[:t_s]
    if carry_color is not None:
        colors = carry_color + colors

    # Outgoing log-transmittance: per strip tile, the inclusive log-term sum
    # over its [start, end) range (plus carry), read at the range's last
    # element; empty ranges pass the carry through.
    strip_ids = tile_base + jnp.arange(t_s, dtype=jnp.int32)
    r_start = ranges[strip_ids, 0].astype(jnp.int32)
    r_end = ranges[strip_ids, 1].astype(jnp.int32)
    hi = cs_incl[jnp.clip(r_end - 1, 0, e - 1)]
    seg_total = jnp.where((r_end > r_start)[:, None], hi, 0.0)
    logt_end = seg_total if carry_logt is None else carry_logt + seg_total
    return colors, logt_end


def assemble_tile_colors(tile_colors, config: RenderConfig):
    """[num_tiles, P, 3] per-tile pixels -> clipped [H, W, 3] image."""
    gh, gw, ts = config.grid_height, config.grid_width, config.tile_size
    img = tile_colors.reshape(gh, gw, ts, ts, 3)
    img = img.transpose(0, 2, 1, 3, 4).reshape(gh * ts, gw * ts, 3)
    img = img[: config.height, : config.width]
    return jnp.clip(img, 0.0, 1.0)


def blend_tiles_xla(
    elements: SortElements,
    ranges,
    frame: GaussianFrameData,
    config: RenderConfig,
    origin_y: int | jax.Array = 0,
):
    """Vectorized blend over all tiles at once (XLA tier).

    Memory scales as O(E * tile_size^2); intended for the CPU, tests and
    small scenes.  Returns a float32 [H, W, 3] image (pre-quantization).

    `origin_y`: absolute pixel row of this image's first row — nonzero when
    blending a sharded strip whose tile ids are strip-local but whose gaussian
    screen positions are global (parallel/dist.py legacy path).
    """
    colors, _ = blend_strip_colors_xla(
        elements, ranges, frame, config, origin_y=origin_y
    )
    return assemble_tile_colors(colors, config)


def quantize_image(img):
    """float [H,W,3] in [0,1] -> uint8 rgba, matching rgba8 unorm imageStore
    (round-to-nearest) with alpha = 255 (RenderGaussians.comp:146-151)."""
    rgb = jnp.round(img * jnp.float32(255.0)).astype(jnp.uint8)
    alpha = jnp.full(rgb.shape[:-1] + (1,), 255, dtype=jnp.uint8)
    return jnp.concatenate([rgb, alpha], axis=-1)
