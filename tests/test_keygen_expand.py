"""Keygen's slot expansion (ops/keygen.py: expand_rows, jnp.repeat) against
a numpy expansion, and the whole keygen pass against the oracle.

The expansion replaces the reference's atomicAdd allocation
(InitSortList.comp:129-150): row i of the packed per-gaussian table fills
counts[i] consecutive slots, in gaussian order, truncated at capacity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _scenes import make_scene
from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.ops import keygen
from vk3dgaussiansplatting_tpu.oracle.numpy_oracle import render_frame_oracle


def _counts(regime):
    rng = np.random.default_rng(7)
    if regime == "random_with_culls":
        c = rng.integers(0, 9, size=700)
        c[rng.random(700) < 0.4] = 0
        return c, int(c.sum()) + 300
    if regime == "long_culled_run":
        c = np.ones(3000, np.int64)
        c[100:2500] = 0
        return c, 1024
    if regime == "overflow_truncation":
        return np.full(300, 11), 1536
    if regime == "dead_tail_unaligned_capacity":
        return np.array([5, 0, 3, 0, 0, 2] * 10), 1000
    if regime == "all_culled":
        return np.zeros(600, np.int64), 512
    if regime == "one_per_row":
        return np.ones(4000, np.int64), 4096
    if regime == "huge_single_gaussians":
        c = rng.integers(0, 2, size=8000)
        c[rng.integers(0, 8000, 30)] = rng.integers(1500, 6000, 30)
        return c, 20_480
    raise ValueError(regime)


REGIMES = (
    "random_with_culls",
    "long_culled_run",
    "overflow_truncation",
    "dead_tail_unaligned_capacity",
    "all_culled",
    "one_per_row",
    "huge_single_gaussians",
)


@pytest.mark.parametrize("regime", REGIMES)
def test_expand_rows_matches_numpy(regime):
    counts, capacity = _counts(regime)
    n = counts.shape[0]
    rng = np.random.default_rng(3)
    packed = np.stack(
        [
            np.arange(n, dtype=np.int32),
            rng.integers(-(2**31), 2**31, size=n).astype(np.int32),
        ],
        axis=-1,
    )
    live = int(min(counts.sum(), capacity))
    want = np.repeat(packed, counts, axis=0)[:live]
    got = np.asarray(
        keygen.expand_rows(
            jnp.asarray(packed), jnp.asarray(counts.astype(np.int32)), capacity
        )
    )
    assert got.shape == (capacity, 2)
    np.testing.assert_array_equal(got[:live], want)


def test_u32_depth_bits_survive_expansion():
    """Depth keys >= 2^31 ride the packed i32 table as bit patterns."""
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 4, size=400).astype(np.int32)
    depth = rng.integers(0, 2**32, size=400, dtype=np.uint64).astype(np.uint32)
    packed = jax.lax.bitcast_convert_type(jnp.asarray(depth), jnp.int32)[:, None]
    capacity = int(counts.sum()) + 128
    got = keygen.expand_rows(packed, jnp.asarray(counts), capacity)[:, 0]
    got = np.asarray(jax.lax.bitcast_convert_type(got, jnp.uint32))
    live = int(counts.sum())
    np.testing.assert_array_equal(got[:live], np.repeat(depth, counts))


@pytest.mark.parametrize("scene", ["simple", "sort", "cloud1"])
def test_keygen_matches_oracle_allocation(scene):
    """Pre-sort element lists equal the oracle's deterministic allocation
    (gaussians in index order, tiles row-major within each)."""
    config = RenderConfig(
        width=128, height=96, capacity_slack_per_tile=32,
        sort_algorithm=SortAlgorithm.XLA_SORT,
    )
    table, camera = make_scene(scene, config.aspect)
    oracle = render_frame_oracle(table, camera, config)
    view, proj = camera.matrices()
    el, _ = keygen.generate_sort_elements(
        jax.tree.map(jnp.asarray, table),
        jnp.asarray(view), jnp.asarray(proj),
        jnp.asarray(camera.position, dtype=jnp.float32),
        config, config.sort_capacity(table.num_gaussians),
    )
    inv = np.argsort(oracle.order, kind="stable")
    np.testing.assert_array_equal(np.asarray(el.tile), oracle.tile[inv])
    np.testing.assert_array_equal(np.asarray(el.depth), oracle.depth[inv])
    np.testing.assert_array_equal(np.asarray(el.index), oracle.index[inv])
    assert int(el.count) == min(oracle.total, el.tile.shape[0])
