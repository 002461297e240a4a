"""Tile-blend kernel (ops/pallas/blend_kernel.py) in interpret mode.

The kernel is held to the sequential numpy oracle (8-bit +-1, the
docs/TOLERANCES.md contract for the blend) over the repo's scenes, at
resolutions with partial edge tiles and at two batch sizes; its carry
in/out is held to the XLA tier's (ops/blend.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from _scenes import SCENE_NAMES, make_scene, sorted_frame
from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.ops import blend as blend_ops
from vk3dgaussiansplatting_tpu.ops.pallas import blend_kernel
from vk3dgaussiansplatting_tpu.oracle.numpy_oracle import render_frame_oracle

# 250x130 and 200x72 leave partial tiles on the right and bottom edges.
RESOLUTIONS = ((250, 130), (200, 72))


def _config(width, height):
    return RenderConfig(
        width=width,
        height=height,
        capacity_slack_per_tile=32,
        sort_algorithm=SortAlgorithm.XLA_SORT,
    )


@functools.lru_cache(maxsize=None)
def _case(scene, width, height):
    config = _config(width, height)
    table, camera = make_scene(scene, config.aspect)
    oracle = render_frame_oracle(table, camera, config)
    el, rg, fr = sorted_frame(table, camera, config)
    return config, oracle, el, rg, fr


@pytest.mark.parametrize("batch", [8, 16])
@pytest.mark.parametrize("res", RESOLUTIONS, ids=lambda r: f"{r[0]}x{r[1]}")
@pytest.mark.parametrize("scene", SCENE_NAMES)
def test_kernel_matches_oracle(scene, res, batch):
    config, oracle, el, rg, fr = _case(scene, *res)
    img = np.asarray(
        blend_kernel.blend_tiles_kernel(el, rg, fr, config, batch=batch)
    )
    assert img.shape == (config.height, config.width, 3)
    np.testing.assert_allclose(img, oracle.image, atol=2e-3)
    u8 = np.asarray(blend_ops.quantize_image(jnp.asarray(img)))
    diff = np.abs(
        u8[..., :3].astype(np.int32) - oracle.image_u8[..., :3].astype(np.int32)
    )
    assert diff.max() <= 1
    assert u8[..., :3].max() > 0  # the scene draws something


def _carry(config, t_s, kind, seed=0):
    p = config.tile_size * config.tile_size
    if kind == "none":
        return None, None
    rng = np.random.default_rng(seed)
    color = rng.uniform(0.0, 0.3, (t_s, p, 3)).astype(np.float32)
    logt = rng.uniform(-4.0, 0.0, (t_s, p)).astype(np.float32)
    # A few pixels arrive already stopped (T below transmittance_stop).
    logt[rng.random((t_s, p)) < 0.05] = -12.0
    return jnp.asarray(color), jnp.asarray(logt)


@pytest.mark.parametrize("row", ["first", "middle"])
@pytest.mark.parametrize("carry", ["none", "random"])
@pytest.mark.parametrize("scene", ["simple", "sort", "cloud1"])
def test_strip_carry_matches_xla(scene, carry, row):
    config, _oracle, el, rg, fr = _case(scene, 250, 130)
    gw = config.grid_width
    tile_base = 0 if row == "first" else (config.grid_height // 2) * gw
    cc, cl = _carry(config, gw, carry)
    kw = dict(
        tile_base=tile_base, num_strip_tiles=gw, carry_color=cc, carry_logt=cl
    )
    col_k, logt_k = blend_kernel.blend_strip_colors_kernel(
        el, rg, fr, config, **kw
    )
    col_x, logt_x = blend_ops.blend_strip_colors_xla(el, rg, fr, config, **kw)
    np.testing.assert_allclose(
        np.asarray(col_k), np.asarray(col_x), atol=2e-3
    )
    # The kernel stops updating T once a pixel is done; the XLA tier keeps
    # multiplying.  Both agree on which pixels are done and on T above it.
    stop = config.transmittance_stop
    t_k = np.maximum(np.exp(np.asarray(logt_k)), stop)
    t_x = np.maximum(np.exp(np.asarray(logt_x)), stop)
    np.testing.assert_allclose(t_k, t_x, rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("scene", ["sort", "skewed"])
def test_routed_features_match_indexed(scene):
    """Pre-gathered per-element features (the distributed exchange's form)
    give the same strip as features read by gaussian index."""
    config, _oracle, el, rg, fr = _case(scene, 250, 130)
    feats = blend_ops.gather_element_features(el, fr)
    kw = dict(tile_base=0, num_strip_tiles=config.num_tiles)
    by_index = blend_kernel.blend_strip_colors_kernel(el, rg, fr, config, **kw)
    routed = blend_kernel.blend_strip_colors_kernel(
        el, rg, None, config, features=feats, **kw
    )
    for a, b in zip(by_index, routed):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_feature_rows_layout():
    n = 5
    sp = jnp.arange(2 * n, dtype=jnp.float32).reshape(n, 2)
    ca = jnp.arange(4 * n, dtype=jnp.float32).reshape(n, 4) + 100
    ci = jnp.arange(3 * n, dtype=jnp.float32).reshape(n, 3) + 1
    rows = np.asarray(blend_kernel.feature_rows(sp, ca, ci))
    assert rows.shape == (n, blend_kernel.NUM_FEATURES)
    np.testing.assert_array_equal(rows[:, 0:2], sp)
    np.testing.assert_array_equal(
        rows[:, 2:5], np.asarray(ci) * np.array([-0.5, -1.0, -0.5])
    )
    np.testing.assert_array_equal(rows[:, 5:9], ca)
    assert not rows[:, 9:].any()


def test_assemble_tile_colors_crops_edge_tiles():
    """The kernel's [tiles, 3, P] rows become the image through
    ops.blend.assemble_tile_colors: tile-major layout, edge crop, clip."""
    config = _config(40, 20)  # 3x2 tiles, last column and row partial
    p = config.tile_size * config.tile_size
    rgb = np.zeros((config.num_tiles, 3, p), np.float32)
    for t in range(config.num_tiles):
        rgb[t, 0] = t / 10.0  # red encodes the tile id
        rgb[t, 1] = np.arange(p) / p  # green encodes the in-tile pixel
    rgb[0, 2] = 5.0  # clipped to 1
    img = np.asarray(
        blend_ops.assemble_tile_colors(
            jnp.asarray(rgb).transpose(0, 2, 1), config
        )
    )
    assert img.shape == (20, 40, 3)
    assert img[0, 0, 2] == 1.0
    # pixel (y=17, x=33) lies in tile row 1, column 2: tile 5, local (1, 1)
    assert img[17, 33, 0] == pytest.approx(0.5)
    assert img[17, 33, 1] == pytest.approx((1 * 16 + 1) / p)
