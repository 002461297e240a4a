"""Tile-blend kernel compiled for the card (no interpret mode).

Marked ``gpu``: these skip without an NVIDIA GPU and run on the card in
phase 2 of ``python chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _scenes import make_scene, sorted_frame
from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.ops import blend as blend_ops
from vk3dgaussiansplatting_tpu.ops.pallas import blend_kernel
from vk3dgaussiansplatting_tpu.oracle.numpy_oracle import render_frame_oracle

pytestmark = pytest.mark.gpu

CONFIG = RenderConfig(
    width=250, height=130, capacity_slack_per_tile=32,
    sort_algorithm=SortAlgorithm.XLA_SORT,
)


def _u8(img):
    return np.asarray(blend_ops.quantize_image(jnp.asarray(img)))[..., :3]


@pytest.mark.parametrize("scene", ["simple", "sort", "skewed", "cloud1"])
def test_compiled_kernel_matches_xla_tier(gpu, scene):
    table, camera = make_scene(scene, CONFIG.aspect)
    el, rg, fr = sorted_frame(table, camera, CONFIG)
    got = blend_kernel.blend_tiles_kernel(el, rg, fr, CONFIG)
    with jax.default_matmul_precision("highest"):
        want = blend_ops.blend_tiles_xla(el, rg, fr, CONFIG)
    d = np.abs(_u8(got).astype(np.int32) - _u8(want).astype(np.int32))
    assert d.max() <= 1
    assert _u8(got).max() > 0


def test_compiled_strip_carry_matches_xla(gpu):
    table, camera = make_scene("cloud1", CONFIG.aspect)
    el, rg, fr = sorted_frame(table, camera, CONFIG)
    gw = CONFIG.grid_width
    p = CONFIG.tile_size ** 2
    rng = np.random.default_rng(0)
    kw = dict(
        tile_base=gw * 2,
        num_strip_tiles=gw,
        carry_color=jnp.asarray(rng.uniform(0, 0.3, (gw, p, 3)), jnp.float32),
        carry_logt=jnp.asarray(rng.uniform(-4, 0, (gw, p)), jnp.float32),
    )
    col_k, _ = blend_kernel.blend_strip_colors_kernel(el, rg, fr, CONFIG, **kw)
    with jax.default_matmul_precision("highest"):
        col_x, _ = blend_ops.blend_strip_colors_xla(el, rg, fr, CONFIG, **kw)
    np.testing.assert_allclose(
        np.asarray(col_k), np.asarray(col_x), atol=2e-3
    )


def test_renderer_uses_kernel_and_matches_oracle(gpu):
    from vk3dgaussiansplatting_tpu.pipeline import Renderer

    table, camera = make_scene("sort", CONFIG.aspect)
    renderer = Renderer(CONFIG)
    assert renderer.use_pallas_blend
    renderer.init_for_scene(table)
    got = renderer.draw_numpy(camera)[..., :3].astype(np.int32)
    oracle = render_frame_oracle(table, camera, CONFIG)
    assert np.abs(got - oracle.image_u8[..., :3].astype(np.int32)).max() <= 1
