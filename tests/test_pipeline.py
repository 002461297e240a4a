"""End-to-end pipeline parity vs the sequential numpy oracle.

The reference's only fixtures are its two synthetic scenes (SURVEY.md §4);
they are reproduced here as pytest fixtures and held to *exact* integer parity
(sort element lists, sorted order, ranges) and 8-bit +-1 image parity against
the oracle.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vk3dgaussiansplatting_tpu.core.config import (
    SENTINEL,
    RenderConfig,
    SortAlgorithm,
)
from vk3dgaussiansplatting_tpu.ops import keygen, ranges as ranges_ops, sort as sort_ops
from vk3dgaussiansplatting_tpu.ops import blend as blend_ops
from vk3dgaussiansplatting_tpu.oracle.numpy_oracle import render_frame_oracle
from vk3dgaussiansplatting_tpu.pipeline import Renderer
from vk3dgaussiansplatting_tpu.scenes.synthetic import (
    SimpleTestGaussiansScene,
    TestSortScene,
)

# Small config so the sequential oracle stays fast: 256x256 -> 256 tiles,
# slack 32 elements/tile -> capacity 16384 (the TestSortScene gaussians sit
# just in front of the near plane and overlap many tiles each).
TEST_CONFIG = RenderConfig(
    width=256,
    height=256,
    capacity_slack_per_tile=32,
    sort_algorithm=SortAlgorithm.XLA_SORT,
)


def _run_both(scene_cls, config=TEST_CONFIG):
    scene = scene_cls(aspect=config.aspect)
    scene.init()
    scene.camera.set_aspect(config.aspect)
    table = scene.gaussians()
    oracle = render_frame_oracle(table, scene.camera, config)

    renderer = Renderer(config, use_pallas_blend=False)
    renderer.init_for_scene(table)
    out = renderer.draw(scene.camera)
    return scene, table, oracle, renderer, out


@pytest.fixture(scope="module")
def simple_scene_results():
    return _run_both(SimpleTestGaussiansScene)


@pytest.fixture(scope="module")
def sort_scene_results():
    return _run_both(TestSortScene)


def test_keygen_exact_parity(simple_scene_results):
    scene, table, oracle, renderer, _ = simple_scene_results
    view, proj = scene.camera.matrices()
    elements, frame = keygen.generate_sort_elements(
        renderer.table,
        jnp.asarray(view),
        jnp.asarray(proj),
        jnp.asarray(scene.camera.position),
        TEST_CONFIG,
        renderer.capacity,
    )
    # Pre-sort element list must match the oracle's deterministic allocation
    # exactly (same prefix-sum order).
    np.testing.assert_array_equal(np.asarray(elements.tile), oracle.tile[np.argsort(oracle.order, kind="stable")])


def _sorted_elements(scene, renderer):
    view, proj = scene.camera.matrices()
    elements, frame = keygen.generate_sort_elements(
        renderer.table,
        jnp.asarray(view),
        jnp.asarray(proj),
        jnp.asarray(scene.camera.position),
        renderer.config,
        renderer.capacity,
    )
    return sort_ops.sort_elements(elements, renderer.config), frame


def test_sort_order_matches_oracle(sort_scene_results):
    scene, _, oracle, renderer, _ = sort_scene_results
    sorted_elems, _ = _sorted_elements(scene, renderer)
    np.testing.assert_array_equal(np.asarray(sorted_elems.tile), oracle.tile)
    np.testing.assert_array_equal(np.asarray(sorted_elems.depth), oracle.depth)
    np.testing.assert_array_equal(np.asarray(sorted_elems.index), oracle.index)


def test_sort_scene_depth_keys_are_crafted(sort_scene_results):
    """TestSortScene gaussians are placed so depth keys are (i+1)*1024
    (TestSortScene.cpp:15-33) — validates the depth-key quantization."""
    scene, _, oracle, renderer, _ = sort_scene_results
    live = oracle.index != SENTINEL
    depths = oracle.depth[live].astype(np.uint64)
    # keys ascend within each tile
    tiles = oracle.tile[live]
    key64 = (tiles.astype(np.uint64) << 32) | depths
    assert (np.diff(key64.astype(np.int64)) >= 0).all()
    # quantized keys should be close to the crafted (i+1)*1024 grid
    idx = oracle.index[live]
    expect = (idx.astype(np.uint64) + 1) * 1024
    err = np.abs(depths.astype(np.int64) - expect.astype(np.int64))
    assert err.max() <= 1024  # within one quantization step of the target


def test_sort_invariants(sort_scene_results):
    scene, _, _, renderer, _ = sort_scene_results
    sorted_elems, _ = _sorted_elements(scene, renderer)
    tile = np.asarray(sorted_elems.tile)
    depth = np.asarray(sorted_elems.depth)
    key64 = (tile.astype(np.uint64) << 32) | depth.astype(np.uint64)
    assert (np.diff(key64.astype(np.float64)) >= 0).all()
    # sentinels at the end
    live = tile != SENTINEL
    n_live = int(np.asarray(sorted_elems.count))
    assert live.sum() == n_live
    assert not live[n_live:].any()


def test_ranges_exact_parity(sort_scene_results):
    scene, _, oracle, renderer, _ = sort_scene_results
    sorted_elems, _ = _sorted_elements(scene, renderer)
    got = np.asarray(
        ranges_ops.find_ranges(sorted_elems, renderer.config.num_tiles)
    )
    np.testing.assert_array_equal(got, oracle.ranges)


def test_ranges_cover_live_elements(sort_scene_results):
    scene, _, oracle, renderer, _ = sort_scene_results
    live = oracle.tile != SENTINEL
    covered = np.zeros(len(oracle.tile), dtype=bool)
    for t in range(renderer.config.num_tiles):
        s, e = oracle.ranges[t]
        covered[s:e] = True
    # Every live element is inside its tile's range — except the final slot
    # when the sort list is completely full: the reference's FindRanges writes
    # end = E-1 for the last thread, dropping that element (FindRanges.comp:
    # 63-69), a quirk both implementations reproduce.
    check = live.copy()
    check[-1] = False
    assert covered[check].all()


@pytest.mark.parametrize("fixture", ["simple_scene_results", "sort_scene_results"])
def test_image_matches_oracle(fixture, request):
    scene, _, oracle, _, out = request.getfixturevalue(fixture)
    img = np.asarray(out.image)
    np.testing.assert_allclose(img, oracle.image, atol=2e-3)
    u8 = np.asarray(out.image_u8)
    diff = np.abs(u8[..., :3].astype(np.int32) - oracle.image_u8[..., :3].astype(np.int32))
    assert diff.max() <= 1, f"8-bit image differs by up to {diff.max()}"
    # the scene must actually draw something
    assert u8[..., :3].max() > 0


def test_element_count_matches(simple_scene_results):
    _, _, oracle, _, out = simple_scene_results
    assert int(np.asarray(out.num_elements)) == min(
        oracle.total, TEST_CONFIG.sort_capacity(16)
    )


def test_capacity_formula():
    # Renderer.cpp:725: ceilPow2(numGaussians + 64*16*numTiles)
    config = RenderConfig(width=1920, height=1080)
    assert config.num_tiles == 120 * 68
    assert config.sort_capacity(5_834_784) == 2 ** 24  # Garden-30k @1080p
    assert config.num_sort_bits() == 48  # 32 + 13 tile bits -> roundUp4 = 48


def test_overflow_drop_rule():
    """Elements beyond capacity are dropped (InitSortList.comp:143)."""
    from vk3dgaussiansplatting_tpu.scenes.synthetic import simple_test_gaussians_table

    config = RenderConfig(
        width=256, height=256, capacity_slack_per_tile=0, capacity_pow_two=False,
        sort_algorithm=SortAlgorithm.XLA_SORT,
    )
    table = simple_test_gaussians_table()
    # capacity = num gaussians only -> guaranteed overflow of tile expansion
    from vk3dgaussiansplatting_tpu.render.camera import Camera

    cam = Camera(1.0)
    cam.set_position((0.0, 0.0, 2.0))
    cam.set_rotation(np.pi, 0.0)
    view, proj = cam.matrices()
    elements, _ = keygen.generate_sort_elements(
        jax.tree.map(jnp.asarray, table),
        jnp.asarray(view),
        jnp.asarray(proj),
        jnp.asarray(cam.position),
        config,
        config.sort_capacity(16),
    )
    assert elements.tile.shape[0] == 16
    assert int(np.asarray(elements.count)) == 16  # clamped to capacity
    assert (np.asarray(elements.tile) != SENTINEL).all()


def test_far_depth_keys_roundtrip_exactly():
    """Depth keys >= 2^31 must survive the keygen's packed i32 gather
    (uint32<->int32 reinterpret is modular, not saturating)."""
    from vk3dgaussiansplatting_tpu.models.gaussians import concat_tables, make_gaussian
    from vk3dgaussiansplatting_tpu.oracle.numpy_oracle import depth_key_np
    from vk3dgaussiansplatting_tpu.render.camera import Camera

    t = concat_tables(
        [
            make_gaussian((0.0, 0.0, -60.0), scale=(0.5, 0.5, 0.5)),
            make_gaussian((0.1, 0.0, -80.0), scale=(0.5, 0.5, 0.5)),
        ]
    )
    cfg = RenderConfig(
        width=64, height=64, capacity_slack_per_tile=8,
        sort_algorithm=SortAlgorithm.XLA_SORT,
    )
    cam = Camera(1.0)
    cam.set_rotation(np.pi, 0.0)
    view, proj = cam.matrices()
    el, _ = keygen.generate_sort_elements(
        jax.tree.map(jnp.asarray, t),
        jnp.asarray(view), jnp.asarray(proj), jnp.asarray(cam.position),
        cfg, cfg.sort_capacity(2),
    )
    d = np.asarray(el.depth)
    live = np.asarray(el.index) != SENTINEL
    pv = (t.position @ view[:3, :3].T + view[:3, 3]).astype(np.float32)
    want = set(depth_key_np(pv[:, 2], cfg).tolist())
    assert set(d[live].tolist()) == want
    assert min(want) >= 2**31  # the far-depth regime is actually exercised
