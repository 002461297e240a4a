"""Representative-scale exercise of the ResourceManager pipeline.

The reference loads 5.8M-gaussian captures through hapPLY + per-gaussian
transforms + a Morton sort (ResourceManager.cpp:167-300).  The unit tests
drive the same pipeline on a 384-gaussian fixture; this test generates a
multi-million-gaussian binary .ply, round-trips it through the native C++
parser + activation transforms + Morton ordering, cross-checks the native
and Python parsers on a slice, and renders one frame — covering the scale
gap of the fixture-size tests.

Opt-in (slow, ~2 GB of disk + a few minutes):
    RUN_SCALE_TESTS=1 python -m pytest tests/test_loader_scale.py -q
"""

import os

import numpy as np
import pytest

from vk3dgaussiansplatting_tpu.io import ply
from vk3dgaussiansplatting_tpu.native import runtime
from vk3dgaussiansplatting_tpu.utils.morton import encode_zorder, morton_order

pytestmark = pytest.mark.skipif(
    not os.environ.get("RUN_SCALE_TESTS"),
    reason="scale test is opt-in (RUN_SCALE_TESTS=1); writes a ~1.4 GB .ply",
)

N = 3_000_000  # representative of the 5.8M-point Garden capture


@pytest.fixture(scope="module")
def big_ply(tmp_path_factory):
    rng = np.random.default_rng(77)
    path = tmp_path_factory.mktemp("scale") / "big.ply"
    cols = {}
    for name in (
        ["x", "y", "z", "scale_0", "scale_1", "scale_2",
         "rot_0", "rot_1", "rot_2", "rot_3", "opacity",
         "f_dc_0", "f_dc_1", "f_dc_2"]
        + [f"f_rest_{i}" for i in range(45)]
    ):
        cols[name] = rng.normal(size=N).astype(np.float32)
    ply.write_ply(path, cols)
    return path, cols


def test_native_parser_at_scale(big_ply):
    path, cols = big_ply
    native = runtime.try_load_gaussians(path)
    assert native is not None, "native fast path must handle multi-M files"
    assert len(native["xyz"]) == N
    # bit-exact agreement with the python parser on every column family
    python = ply.gaussian_columns_from_ply(path)
    for key in python:
        np.testing.assert_array_equal(native[key], python[key], err_msg=key)


def test_full_load_pipeline_at_scale(big_ply):
    path, _cols = big_ply
    table = ply.load_gaussians(path)  # parse + activations + Morton sort
    assert table.num_gaussians == N
    assert np.isfinite(table.position).all()
    assert np.isfinite(table.scale).all() and (table.scale > 0).all()
    assert ((table.opacity > 0) & (table.opacity < 1)).all()
    # Morton order must hold over the min-max-normalized positions
    # (ResourceManager.cpp:283-297): recompute keys with the module's own
    # normalization and check they are non-decreasing in table order.
    pos = np.asarray(table.position, np.float32)
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    delta = np.where(hi - lo == 0.0, np.float32(1.0), hi - lo)
    grid = np.minimum(
        ((pos - lo) / delta * np.float32(1023)).astype(np.uint32),
        np.uint32(1023),
    )
    codes = encode_zorder(grid)
    assert (np.diff(codes.astype(np.int64)) >= 0).all()
    # and morton_order on the already-sorted table is a no-op permutation
    # up to equal-key ties
    perm = morton_order(pos)
    assert (codes[perm] == codes).all()


def test_render_loaded_scene_at_scale(big_ply):
    path, _cols = big_ply
    import jax

    jax.config.update("jax_platforms", "cpu")
    import math

    from vk3dgaussiansplatting_tpu.core.config import (
        RenderConfig,
        SortAlgorithm,
    )
    from vk3dgaussiansplatting_tpu.pipeline import Renderer
    from vk3dgaussiansplatting_tpu.render.camera import Camera

    table = ply.load_gaussians(path)
    config = RenderConfig(
        width=320,
        height=180,
        capacity_slack_per_tile=64,
        sort_algorithm=SortAlgorithm.XLA_SORT,
    )
    renderer = Renderer(config, use_pallas_blend=False)
    renderer.init_for_scene(table)
    cam = Camera(config.aspect)
    cam.set_position((0.0, 0.0, 4.0))
    cam.set_rotation(math.pi, 0.0)
    out = renderer.draw(cam)
    img = np.asarray(out.image_u8)
    assert img.shape == (180, 320, 4)
    assert int(out.num_elements) > 0
