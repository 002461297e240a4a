"""Tile blend kernel for NVIDIA GPUs — the RenderGaussians pass in Pallas
(Triton route).

Follows the reference's own GPU design (RenderGaussians.comp:81-144):

  * one program per 16x16 screen tile; its 256 pixels are the block's
    lanes (two pixels per thread at ``num_warps=4``);
  * a loop inside the program walks the tile's sorted ``[start, end)``
    range from ``ranges`` in batches of ``batch`` elements;
  * each element's features are fetched by its sorted gaussian index from
    a per-gaussian feature table (no post-sort gather pass);
  * front-to-back order per pixel: ``color += T * alpha * rgb`` then
    ``T *= 1 - alpha``, for elements with ``f <= 0`` and
    ``alpha >= alpha_cutoff``; a pixel stops after the element that takes
    T below ``transmittance_stop``;
  * the loop leaves once every pixel of the tile has stopped (checked once
    per batch).

The batch is unrolled in Python: the scalar loads of its elements do not
depend on the transmittance recurrence, so the compiler can issue them
ahead of the arithmetic.  All sums are float32 and elementwise; the kernel
has no matrix product.

The distributed depth-banded pipeline (parallel/dist.py) chains bands
through the same kernel: `blend_strip_colors_kernel` blends a band from
T = 1 and composes color_out = color_in + T_in * color_band and
T_out = T_in * T_band outside the kernel.  A band pixel then stops at
T_band < stop rather than at T_in * T_band < stop; what it adds past the
exact stop is below T_in * T_band < transmittance_stop (1e-4) in total.

Interpret mode (CPU) is for tests only: it is chosen on the CPU backend or
by an explicit ``interpret=True``, never on a GPU (utils/device.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ...core.config import RenderConfig
from ...utils import device
from .. import blend as blend_ops
from ..keygen import GaussianFrameData, SortElements

# Elements per unrolled batch; the early-out is checked once per batch.
BATCH = 16
# 4 warps = 128 threads, two pixels of the 16x16 tile each: faster than
# one pixel per thread on an H100 (PERF.md).
NUM_WARPS = 4
# Feature-table row: gx, gy, a', b', c', r, g, b, galpha, then padding to
# 64 bytes so a row is two aligned 32-byte sectors.
NUM_FEATURES = 16
_GX, _GY, _A, _B, _C, _R, _G, _BL, _ALPHA = range(9)


def feature_rows(screen_pos, color_alpha, cov_inv):
    """Blend features as [N, NUM_FEATURES] f32 rows.

    The inverse-covariance terms are pre-scaled (a' = -a/2, b' = -b,
    c' = -c/2) so the kernel evaluates f = a'dx^2 + c'dy^2 + b'dxdy;
    scaling by powers of two is exact, so f equals the GLSL form
    -0.5(a dx^2 + c dy^2) - b dx dy (RenderGaussians.comp:117-124) up to
    the compiler's choice of fused multiply-adds.
    """
    n = screen_pos.shape[0]
    cov_scaled = cov_inv * jnp.array([-0.5, -1.0, -0.5], jnp.float32)
    return jnp.concatenate(
        [
            screen_pos,
            cov_scaled,
            color_alpha,
            jnp.zeros((n, NUM_FEATURES - 9), jnp.float32),
        ],
        axis=-1,
    )


def _kernel(
    start_ref,
    end_ref,
    meta_ref,  # [2] i32: (origin_y pixel row, tile_base global tile id)
    index_ref,
    feat_ref,
    out_ref,
    *,
    config: RenderConfig,
    batch: int,
    by_index: bool,
):
    t = pl.program_id(0)
    ts = config.tile_size
    p = ts * ts
    stop = jnp.float32(config.transmittance_stop)
    cutoff = jnp.float32(config.alpha_cutoff)

    start = start_ref[t]
    end = end_ref[t]
    tile = t + meta_ref[1]
    tile_x = tile % config.grid_width
    tile_y = tile // config.grid_width
    pix = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    # Pixel p = v * ts + u within the tile (the GLSL local index layout).
    u = (tile_x * ts + pix % ts).astype(jnp.float32)
    v = (meta_ref[0] + tile_y * ts + pix // ts).astype(jnp.float32)

    zeros = jnp.zeros((p,), jnp.float32)
    t0 = jnp.ones((p,), jnp.float32)

    def body(carry):
        k0, _alive, trans, r, g, b = carry
        for k in range(batch):
            slot = k0 + k
            valid = slot < end
            # Past the range end, re-read the last element (always a live
            # slot) and zero its opacity: no masked loads needed.
            pos = jnp.minimum(slot, end - 1)
            gid = index_ref[pos] if by_index else pos
            gx = feat_ref[gid, _GX]
            gy = feat_ref[gid, _GY]
            fa = feat_ref[gid, _A]
            fb = feat_ref[gid, _B]
            fc = feat_ref[gid, _C]
            galpha = jnp.where(valid, feat_ref[gid, _ALPHA], 0.0)
            # evalX = gScreenPos - pixel; evalX.y = -evalX.y
            # (RenderGaussians.comp:117).
            dx = gx - u
            dy = v - gy
            f = (fa * dx * dx + fc * dy * dy) + fb * dx * dy
            alpha = galpha * jnp.exp(f)
            take = (f <= 0.0) & (alpha >= cutoff) & (trans >= stop)
            w = jnp.where(take, trans * alpha, 0.0)
            r = r + w * feat_ref[gid, _R]
            g = g + w * feat_ref[gid, _G]
            b = b + w * feat_ref[gid, _BL]
            trans = jnp.where(take, trans * (1.0 - alpha), trans)
        alive = jnp.max(trans) >= stop
        return k0 + batch, alive, trans, r, g, b

    def cond(carry):
        k0, alive = carry[0], carry[1]
        return (k0 < end) & alive

    alive0 = jnp.max(t0) >= stop
    _, _, trans, r, g, b = jax.lax.while_loop(
        cond, body, (start, alive0, t0, zeros, zeros, zeros)
    )
    out_ref[0, :] = r
    out_ref[1, :] = g
    out_ref[2, :] = b
    out_ref[3, :] = trans


def _whole(shape):
    return pl.BlockSpec(shape, lambda t: (0,) * len(shape))


def _tile_block(p):
    return pl.BlockSpec((None, 4, p), lambda t: (t, 0, 0))


def blend_tile_rows(
    index,
    table,
    ranges,
    config: RenderConfig,
    *,
    num_tiles: int | None = None,
    tile_base: int | jax.Array = 0,
    origin_y: int | jax.Array = 0,
    by_index: bool = True,
    batch: int = BATCH,
    interpret: bool | None = None,
):
    """Run the kernel over tiles [tile_base, tile_base + num_tiles).

    Args:
      index: [E] sorted gaussian index per element (32-bit integers);
        ignored when ``by_index`` is False (then element e reads row e).
      table: [N, NUM_FEATURES] f32 feature rows (``feature_rows``).
      ranges: [num_tiles, 2] (start, end) element ranges of these tiles.
    Returns [num_tiles, 4, P] f32: unclipped r, g, b and the final T.
    """
    if interpret is None:
        interpret = device.kernel_interpret()
    t_s = config.num_tiles if num_tiles is None else num_tiles
    p = config.tile_size * config.tile_size
    starts = ranges[:, 0].astype(jnp.int32)
    ends = ranges[:, 1].astype(jnp.int32)
    meta = jnp.stack(
        [jnp.asarray(origin_y, jnp.int32), jnp.asarray(tile_base, jnp.int32)]
    )
    args = [starts, ends, meta, index.astype(jnp.int32), table]
    return pl.pallas_call(
        functools.partial(
            _kernel,
            config=config,
            batch=batch,
            by_index=by_index,
        ),
        out_shape=jax.ShapeDtypeStruct((t_s, 4, p), jnp.float32),
        grid=(t_s,),
        in_specs=[_whole(a.shape) for a in args],
        out_specs=_tile_block(p),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="tile_blend",
    )(*args)


@functools.partial(jax.jit, static_argnames=("config", "batch", "interpret"))
def blend_tiles_kernel(
    elements: SortElements,
    ranges,
    frame: GaussianFrameData,
    config: RenderConfig,
    origin_y: int | jax.Array = 0,
    *,
    batch: int = BATCH,
    interpret: bool | None = None,
):
    """Blend every tile; returns the float32 [H, W, 3] image
    (pre-quantization), the kernel counterpart of ``blend_tiles_xla``."""
    table = feature_rows(frame.screen_pos, frame.color_alpha, frame.cov_inv)
    out = blend_tile_rows(
        elements.index,
        table,
        ranges,
        config,
        origin_y=origin_y,
        batch=batch,
        interpret=interpret,
    )
    return blend_ops.assemble_tile_colors(
        out[:, :3, :].transpose(0, 2, 1), config
    )


def blend_strip_colors_kernel(
    elements: SortElements,
    ranges,
    frame: GaussianFrameData | None,
    config: RenderConfig,
    *,
    tile_base: int | jax.Array = 0,
    num_strip_tiles: int | None = None,
    carry_color=None,
    carry_logt=None,
    features=None,
    interpret: bool | None = None,
):
    """Carry-aware strip blend with the same contract as
    ``ops.blend.blend_strip_colors_xla``.

    ``ranges`` is the GLOBAL [T_total, 2] table (sliced here at
    ``tile_base``); element tile ids are global.  ``features``, when given,
    is the pre-routed per-element (screen_pos [E,2], color_alpha [E,4],
    cov_inv [E,3]) of the distributed exchange, read by element slot.

    Returns (colors [T_s, P, 3] unclipped, logt_end [T_s, P]).
    """
    t_s = config.num_tiles if num_strip_tiles is None else num_strip_tiles
    if features is None:
        table = feature_rows(frame.screen_pos, frame.color_alpha, frame.cov_inv)
        by_index = True
    else:
        table = feature_rows(*features)
        by_index = False
    strip_ranges = jax.lax.dynamic_slice_in_dim(
        ranges, jnp.asarray(tile_base, jnp.int32), t_s, 0
    )
    out = blend_tile_rows(
        elements.index,
        table,
        strip_ranges,
        config,
        num_tiles=t_s,
        tile_base=tile_base,
        by_index=by_index,
        interpret=interpret,
    )
    local = out[:, :3, :].transpose(0, 2, 1)  # [T_s, P, 3]
    # log(0) = -inf for a fully stopped pixel: a later band then adds
    # nothing, as the sequential recurrence would.
    logt = jnp.log(out[:, 3, :])
    if carry_logt is not None:
        local = jnp.exp(carry_logt)[:, :, None] * local
        logt = carry_logt + logt
    if carry_color is not None:
        local = carry_color + local
    return local, logt
