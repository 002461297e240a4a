"""Distributed frame pipeline — multi-chip rendering via shard_map.

Design (SURVEY.md §7 step 6; no reference counterpart — the reference is
single-GPU).  The per-frame global sort + blend is distributed the way ring
attention distributes sequence: shard the element list, exchange by
ownership, and split every tile's *depth range* across devices so no single
hot tile can serialize a chip.

  1. **Gaussian sharding**: the table is split evenly over the mesh's
     "shard" axis; each device runs keygen on its slice (global gaussian ids
     = local id + shard offset).  Local keygen capacity carries the full
     per-tile slack formula so shard skew does not drop elements a single
     device would keep.
  2. **Frame-data replication**: per-gaussian blend inputs (color, inverse
     covariance, screen position — 48 B/gaussian) are all-gathered so any
     device can blend elements referencing any gaussian.
  3. **Depth-banded tile-ownership exchange**: tile t's elements are routed
     to device (owner(t) + band(depth)) mod ndev, where band() partitions
     the frame's depth keys into ndev quantile bands (thresholds from a
     device-uniform all-gathered depth sample).  EVERY tile's range is thus
     split ~evenly across all devices — a hot tile covered by millions of
     splats costs each device ~1/ndev of it, and each (src, dst) exchange
     slab sees ~1/ndev of a device's elements regardless of tile skew, so
     slab capacity scales as local_capacity/ndev instead of local_capacity.
     Slab overflow still drops (the reference's overflow rule,
     InitSortList.comp:143) but now only under extreme *depth* skew.
     Bucketing is scatter-free: stable sort by destination + searchsorted
     run starts + one packed gather.
  4. **Local sort**: each device 3-key sorts its received elements by
     (tile, depth, gaussian id) — global tile ids; its slice of tile t is
     the band's depth-contiguous sub-range of t's global sorted order.
  5. **Systolic banded blend**: ndev phases.  In phase s, device d blends
     the tiles owned by g = (d - s) mod ndev — exactly the band-s slice of
     those tiles — seeded by the (color, logT) carry received from device
     d-1 (which holds band s-1), then ppermutes its result to d+1.  The
     front-to-back over-operator is associative in the transmittance monoid,
     and the carry chain applies bands in depth order, so the composition
     matches the sequential blend up to float association (docs/TOLERANCES
     image contract); after the final phase each device holds its own
     strip's finished tiles.  Work per phase is balanced even under extreme
     tile skew because every device processes one band of every strip.

Parity: element routing is an exact partition of the single-device sorted
element multiset (band boundaries are depth-value thresholds, so bands
concatenate to the global (tile, depth, id) order); images match
single-device within the documented float tolerances.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..core.config import SENTINEL, RenderConfig
from ..models.gaussians import GaussianTable
from ..ops import blend as blend_ops
from ..ops import keygen as keygen_ops
from ..ops import ranges as ranges_ops
from ..ops.keygen import GaussianFrameData, SortElements
from .mesh import SHARD_AXIS

_DEPTH_SAMPLE = 512  # per-device depth-quantile sample size


def _pad_table(table: GaussianTable, multiple: int) -> GaussianTable:
    """Pad the gaussian table so N divides it; padding gaussians have zero
    opacity AND zero scale, so they cull to zero tiles."""
    import numpy as np

    n = table.position.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return table
    return GaussianTable(
        position=np.concatenate(
            [np.asarray(table.position), np.zeros((pad, 3), np.float32)]
        ),
        scale=np.concatenate([np.asarray(table.scale), np.zeros((pad, 3), np.float32)]),
        rot=np.concatenate(
            [
                np.asarray(table.rot),
                np.tile(np.array([[1, 0, 0, 0]], np.float32), (pad, 1)),
            ]
        ),
        sh=np.concatenate(
            [np.asarray(table.sh), np.zeros((pad, 16, 3), np.float32)]
        ),
        opacity=np.concatenate([np.asarray(table.opacity), np.zeros(pad, np.float32)]),
    )


class DistConfig(NamedTuple):
    """Static distributed-layout parameters."""

    num_devices: int
    tile_rows_per_device: int  # grid_height rows per shard (image sharding)
    local_capacity: int  # keygen capacity per device
    slab_capacity: int  # per-peer exchange capacity
    strip_capacity: int  # per-phase strip element window (see plan notes)


def plan_distribution(
    config: RenderConfig,
    num_gaussians: int,
    num_devices: int,
    slab_slack: float = 2.0,
) -> DistConfig:
    if config.grid_height % num_devices != 0:
        raise ValueError(
            f"grid_height={config.grid_height} must divide evenly over "
            f"{num_devices} devices (pad the image height)"
        )
    # Full slack formula per shard (Renderer.cpp:725 analogue): a shard's
    # gaussians can overlap every tile, so the per-tile slack term does not
    # shrink with ndev.
    n_local = -(-num_gaussians // num_devices)
    local_capacity = config.sort_capacity(n_local)
    # Depth bands spread a device's elements ~evenly over its ndev slabs;
    # slack covers band skew.
    slab_capacity = int(-(-local_capacity // num_devices) * slab_slack)
    # Per-phase strip window: a device's received elements are ~uniform over
    # the ndev strips (depth bands randomize tile ownership per device), so
    # each strip holds ~recv/ndev = ~slab_capacity elements; 2x again for
    # strip skew.  Sliced per phase so the blend's O(E*P) work covers only
    # the phase's strip instead of the whole received list (the round-2
    # scaling bench's dominant overhead).  Tails beyond the window drop
    # (counted in the stats; same overflow family as slabs).
    strip_capacity = min(
        num_devices * slab_capacity, int(slab_capacity * 2 * slab_slack)
    )
    return DistConfig(
        num_devices=num_devices,
        tile_rows_per_device=config.grid_height // num_devices,
        local_capacity=local_capacity,
        slab_capacity=slab_capacity,
        strip_capacity=strip_capacity,
    )


def _depth_band_thresholds(depth, ndev: int):
    """Device-uniform depth-quantile thresholds [ndev-1] from an all-gathered
    strided sample.  Sentinel (dead) depths sort to the sample's tail and are
    excluded by the live count."""
    e = depth.shape[0]
    stride = max(1, e // _DEPTH_SAMPLE)
    sample = depth[::stride]
    all_s = lax.all_gather(sample, SHARD_AXIS, tiled=True)
    all_s = jnp.sort(all_s)
    live_n = jnp.sum(all_s != jnp.uint32(SENTINEL)).astype(jnp.int32)
    k = jnp.arange(1, ndev, dtype=jnp.int32)
    ranks = jnp.clip((live_n * k) // ndev, 0, all_s.shape[0] - 1)
    return all_s[ranks]  # [ndev-1] u32, ascending


def _bucket_by_destination(cols, dest, ndev: int, slab: int):
    """Pack local element columns into [ndev, slab, C] slots grouped by
    destination device, preserving input order within each slab.

    `cols`: list of [E] uint32 columns (keys first; routed feature words may
    follow, bitcast to u32).  Scatter-free: one stable multi-operand sort keyed by
    destination groups the elements, `searchsorted` locates each
    destination's run, and ONE packed row gather materializes the slabs.  A
    run longer than `slab` drops its tail, mirroring the reference's
    sort-list overflow rule (InitSortList.comp:143).
    """
    sorted_cols = jax.lax.sort(
        (dest, *cols), dimension=0, num_keys=1, is_stable=True
    )
    dest_s, cols_s = sorted_cols[0], sorted_cols[1:]
    starts = jnp.searchsorted(
        dest_s, jnp.arange(ndev + 1, dtype=jnp.uint32), side="left"
    ).astype(jnp.int32)  # [ndev+1]

    d_of = jnp.arange(ndev * slab, dtype=jnp.int32) // slab
    r_of = jnp.arange(ndev * slab, dtype=jnp.int32) % slab
    src = starts[d_of] + r_of
    in_run = src < starts[d_of + 1]
    src = jnp.where(in_run, src, 0)

    packed = jnp.stack(cols_s, axis=-1)  # [E, C]
    out = packed[src]  # [ndev*slab, C]
    sent = jnp.uint32(SENTINEL)
    out = jnp.where(in_run[:, None], out, sent)
    return out.reshape(ndev, slab, len(cols))


def _sort3(tile, depth, index):
    """Deterministic 3-key sort (tile, depth, gaussian id)."""
    t, d, i = jax.lax.sort((tile, depth, index), dimension=0, num_keys=3)
    return t, d, i


def make_distributed_render(
    mesh,
    config: RenderConfig,
    dist: DistConfig,
    *,
    use_pallas_blend: bool = False,
    return_stats: bool = False,
    route_features: bool = True,
):
    """Build the jitted multi-device frame function.

    Returns fn(table, view, proj, cam_pos) -> (image, dropped) where image is
    the [H_padded, W, 3] float32 frame (sharded over rows) and dropped is the
    [ndev] int32 per-device count of elements the per-phase strip windows
    truncated.  `dropped` MUST be all-zero for the image to be exact:
    `DistConfig.strip_capacity` (a 2x-slack heuristic over the balanced
    per-strip load) is a correctness knob, and a skewed tile distribution
    that overflows it degrades the affected strips' tiles with no other
    signal.  Callers must check it (tests/test_skew.py asserts both the
    zero-drop steady state and that a forced overflow is reported).  The
    gaussian table must be padded to a multiple of the device count
    (see _pad_table).

    With return_stats, returns (image, stats) instead, where stats is a
    per-device [4] int32 accounting vector
    [live_local, sent_live, recv_live, dropped]:

      live_local — elements generated by this device's keygen shard;
      sent_live  — live elements this device put into the all_to_all slabs
                   (slab capacity minus sentinel padding; live_local minus
                   sent_live = slab-overflow drops);
      recv_live  — live elements received, sorted, and available to the
                   banded blend;
      dropped    — elements truncated by the per-phase strip windows.

    recv_live - dropped is the per-device blended-work denominator the
    scaling benchmark uses (capacity slots are not work); sent_live x
    element bytes is the measured exchange volume (12 B/element keys+id,
    +36 B/element routed features when route_features).
    """
    ndev = dist.num_devices
    tiles_per_dev = dist.tile_rows_per_device * config.grid_width
    strip_height = dist.tile_rows_per_device * config.tile_size
    p = config.tile_size * config.tile_size

    strip_config = dataclasses.replace(config, height=strip_height)

    def per_device(table, view, proj, cam_pos):
        # table leaves arrive as the local shard [N/ndev, ...]
        shard_id = jax.lax.axis_index(SHARD_AXIS)
        n_local = table.position.shape[0]

        elements, frame = keygen_ops.generate_sort_elements(
            table, view, proj, cam_pos, config, dist.local_capacity
        )
        live = elements.index != jnp.uint32(SENTINEL)

        if route_features:
            # Per-element blend features from the LOCAL frame table (indices
            # are still local here); they ride the exchange bitcast to u32,
            # replacing the O(N_total) frame-data all_gather with O(E/ndev)
            # routed rows.
            sp_l, ca_l, ci_l = blend_ops.gather_element_features(
                elements, frame
            )
            feat_u32 = [
                jax.lax.bitcast_convert_type(c, jnp.uint32)
                for arr in (sp_l, ca_l, ci_l)
                for c in (arr[:, j] for j in range(arr.shape[1]))
            ]  # 2 + 4 + 3 = 9 columns
        else:
            feat_u32 = []

        # globalize gaussian ids
        offset = (shard_id * n_local).astype(jnp.uint32)
        elements = SortElements(
            tile=elements.tile,
            depth=elements.depth,
            index=jnp.where(live, elements.index + offset, elements.index),
            count=elements.count,
        )

        if not route_features:
            # replicate frame data (all_gather along shard axis)
            frame_all = GaussianFrameData(
                color_alpha=lax.all_gather(
                    frame.color_alpha, SHARD_AXIS, tiled=True
                ),
                cov2d=lax.all_gather(frame.cov2d, SHARD_AXIS, tiled=True),
                cov_inv=lax.all_gather(frame.cov_inv, SHARD_AXIS, tiled=True),
                screen_pos=lax.all_gather(
                    frame.screen_pos, SHARD_AXIS, tiled=True
                ),
            )
        else:
            frame_all = None

        # depth-banded destination: (owner + band) mod ndev
        thr = _depth_band_thresholds(elements.depth, ndev)
        band = jnp.searchsorted(thr, elements.depth, side="right").astype(
            jnp.uint32
        )
        owner = (elements.tile // jnp.uint32(tiles_per_dev)).astype(jnp.uint32)
        dest = jnp.where(
            live, (owner + band) % jnp.uint32(ndev), jnp.uint32(ndev)
        )
        cols = [elements.tile, elements.depth, elements.index, *feat_u32]
        slabs = _bucket_by_destination(cols, dest, ndev, dist.slab_capacity)
        if return_stats:
            live_local = jnp.sum(live.astype(jnp.int32))
            sent_live = jnp.sum(
                (slabs[:, :, 0] != jnp.uint32(SENTINEL)).astype(jnp.int32)
            )
        recv = lax.all_to_all(slabs, SHARD_AXIS, 0, 0, tiled=False)
        recv = recv.reshape(-1, len(cols))

        # local (tile, depth, id) sort; tile ids stay GLOBAL — this device
        # holds one depth band of every tile.  (tile, index) pairs are
        # unique, so num_keys=3 fully determines the order; routed feature
        # words ride as payload.
        sorted_cols = jax.lax.sort(
            tuple(recv[:, j] for j in range(len(cols))),
            dimension=0,
            num_keys=3,
        )
        st, sd, si = sorted_cols[:3]
        live_r = st != jnp.uint32(SENTINEL)
        count = jnp.sum(live_r).astype(jnp.uint32)
        local_elements = SortElements(tile=st, depth=sd, index=si, count=count)
        if route_features:
            # Dead slots carry sentinel words that bitcast to NaN; zero them
            # (0 * NaN = NaN would poison the blend's color contraction).
            f32 = [
                jnp.where(
                    live_r, jax.lax.bitcast_convert_type(c, jnp.float32), 0.0
                )
                for c in sorted_cols[3:]
            ]
            features = (
                jnp.stack(f32[0:2], axis=-1),  # screen_pos [E, 2]
                jnp.stack(f32[2:6], axis=-1),  # color_alpha [E, 4]
                jnp.stack(f32[6:9], axis=-1),  # cov_inv [E, 3]
            )
        else:
            features = None
        ranges = ranges_ops.find_ranges(local_elements, config.num_tiles)

        # Per-phase strip windows: the received list is tile-sorted, so each
        # strip's elements are one contiguous sub-range.  Slicing the phase's
        # strip to a static window bounds the blend's O(E*P) work by
        # strip_capacity instead of the full received list — the round-2
        # scaling bench's dominant overhead (work-conservation 12% at
        # ndev=4 came from every phase re-materializing all E elements).
        e_recv = st.shape[0]
        strip_cap = min(dist.strip_capacity, e_recv)
        probes = jnp.arange(ndev + 1, dtype=jnp.uint32) * jnp.uint32(
            tiles_per_dev
        )
        bounds = jnp.searchsorted(st, probes, side="left").astype(jnp.int32)
        s0_all = jnp.minimum(bounds[:-1], jnp.int32(e_recv - strip_cap))
        # Window overflow drops the strip's tail (the slab-overflow family;
        # counted so the scaling bench's exact accounting still balances).
        dropped = jnp.sum(
            jnp.maximum(bounds[1:] - s0_all - jnp.int32(strip_cap), 0)
        )

        def slice_strip(g):
            s0 = s0_all[g]
            el = SortElements(
                tile=lax.dynamic_slice_in_dim(st, s0, strip_cap),
                depth=lax.dynamic_slice_in_dim(sd, s0, strip_cap),
                index=lax.dynamic_slice_in_dim(si, s0, strip_cap),
                count=count,
            )
            rng_s = jnp.clip(
                ranges.astype(jnp.int32) - s0, 0, strip_cap
            ).astype(jnp.uint32)
            if features is not None:
                feat_s = tuple(
                    lax.dynamic_slice_in_dim(f, s0, strip_cap, 0)
                    for f in features
                )
            else:
                feat_s = None
            return el, rng_s, feat_s

        # systolic banded blend: phase s blends strip (d - s) mod ndev with
        # the carry from device d-1, then passes the result to d+1.
        perm = [(i, (i + 1) % ndev) for i in range(ndev)]

        def phase(s, carry):
            cc, cl = carry  # [tiles_per_dev, P, 3], [tiles_per_dev, P]
            g = (shard_id - s) % ndev
            tile_base = (g * tiles_per_dev).astype(jnp.int32)
            el_s, rng_s, feat_s = slice_strip(g)
            if use_pallas_blend:
                from ..ops.pallas import blend_kernel

                colors, logt = blend_kernel.blend_strip_colors_kernel(
                    el_s,
                    rng_s,
                    frame_all,
                    config,
                    tile_base=tile_base,
                    num_strip_tiles=tiles_per_dev,
                    carry_color=cc,
                    carry_logt=cl,
                    features=feat_s,
                )
            else:
                colors, logt = blend_ops.blend_strip_colors_xla(
                    el_s,
                    rng_s,
                    frame_all,
                    config,
                    tile_base=tile_base,
                    num_strip_tiles=tiles_per_dev,
                    carry_color=cc,
                    carry_logt=cl,
                    features=feat_s,
                )
            cc2 = lax.ppermute(colors, SHARD_AXIS, perm)
            cl2 = lax.ppermute(logt, SHARD_AXIS, perm)
            return (cc2, cl2)

        init = (
            jnp.zeros((tiles_per_dev, p, 3), jnp.float32),
            jnp.zeros((tiles_per_dev, p), jnp.float32),
        )
        colors, _ = lax.fori_loop(0, ndev, phase, init)
        # After phase ndev-1's ppermute, device d holds the finished tiles of
        # strip d (its own image rows).
        strip = blend_ops.assemble_tile_colors(colors, strip_config)
        if return_stats:
            acct = jnp.stack(
                [
                    live_local,
                    sent_live,
                    count.astype(jnp.int32),
                    dropped.astype(jnp.int32),
                ]
            )
            return strip, acct.reshape(1, 4)
        # Default path surfaces the strip-window overflow count: dropped
        # elements silently degrade the image, so the count rides out with
        # every frame instead of hiding behind return_stats.
        return strip, dropped.astype(jnp.int32).reshape(1)

    table_spec = GaussianTable(
        position=P(SHARD_AXIS),
        scale=P(SHARD_AXIS),
        rot=P(SHARD_AXIS),
        sh=P(SHARD_AXIS),
        opacity=P(SHARD_AXIS),
    )
    out_specs = (P(SHARD_AXIS), P(SHARD_AXIS))
    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(table_spec, P(), P(), P()),
        out_specs=out_specs,
        # pallas_call's out_shape carries no varying-mesh-axes annotation;
        # without this the tile-blend kernel cannot trace under shard_map
        # (jax >= 0.7 check_vma default).
        check_vma=False,
    )
    return jax.jit(fn)
