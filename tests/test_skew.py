"""Hot-tile skew stress (BASELINE configs[4] analogue, CPU mesh scale).

A cloud concentrated so most elements land in a few tiles owned by one
device: the distributed pipeline must stay bit-parity with single-device
when slabs are adequately sized, and degrade by *dropping* (never corrupting)
when they are not — mirroring the reference's overflow-drop rule.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.models.gaussians import NUM_SH_COEFFS, GaussianTable
from vk3dgaussiansplatting_tpu.parallel import dist as dist_mod
from vk3dgaussiansplatting_tpu.parallel.mesh import make_mesh
from vk3dgaussiansplatting_tpu.pipeline import Renderer
from vk3dgaussiansplatting_tpu.render.camera import Camera

NDEV = 4
CONFIG = RenderConfig(
    width=128, height=128, capacity_slack_per_tile=64,
    sort_algorithm=SortAlgorithm.XLA_SORT,
)


def _hot_cloud(n=400, seed=11):
    """Gaussians clustered into a tiny screen region (one hot tile row)."""
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [
            rng.normal(0.0, 0.02, n),  # tight cluster in x
            rng.normal(0.0, 0.01, n),  # and y -> few tiles get everything
            rng.uniform(-3.0, -1.0, n),
        ],
        axis=1,
    ).astype(np.float32)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sh = np.zeros((n, NUM_SH_COEFFS, 3), dtype=np.float32)
    sh[:, 0, :] = rng.uniform(0, 1, (n, 3))
    return GaussianTable(
        position=pos,
        scale=np.full((n, 3), 0.01, np.float32),
        rot=q.astype(np.float32),
        opacity=rng.uniform(0.3, 0.9, n).astype(np.float32),
        sh=sh,
    )


def _camera():
    cam = Camera(1.0)
    cam.set_position((0.0, 0.0, 0.5))
    cam.set_rotation(np.pi, 0.0)
    return cam


def test_skewed_cloud_multi_device_parity():
    table = _hot_cloud()
    cam = _camera()
    renderer = Renderer(CONFIG, use_pallas_blend=False)
    renderer.init_for_scene(table)
    ref = np.asarray(renderer.draw(cam).image)
    assert ref.max() > 0  # the hot cluster is visible

    mesh = make_mesh(NDEV)
    padded = dist_mod._pad_table(table, NDEV)
    plan = dist_mod.plan_distribution(CONFIG, padded.num_gaussians, NDEV)
    fn = dist_mod.make_distributed_render(mesh, CONFIG, plan)
    view, proj = cam.matrices()
    img, dropped = fn(
        jax.tree.map(jnp.asarray, padded),
        jnp.asarray(view),
        jnp.asarray(proj),
        jnp.asarray(cam.position, dtype=jnp.float32),
    )
    img = np.asarray(img)[: CONFIG.height, : CONFIG.width]
    assert int(np.sum(np.asarray(dropped))) == 0
    np.testing.assert_allclose(img, ref, atol=2e-3)


def test_slab_overflow_drops_not_corrupts():
    """Under-sized exchange slabs: output must be a *subset* render (pixels
    only ever get dimmer/equal), never garbage."""
    table = _hot_cloud()
    cam = _camera()
    renderer = Renderer(CONFIG, use_pallas_blend=False)
    renderer.init_for_scene(table)
    ref = np.asarray(renderer.draw(cam).image)

    mesh = make_mesh(NDEV)
    padded = dist_mod._pad_table(table, NDEV)
    plan = dist_mod.plan_distribution(CONFIG, padded.num_gaussians, NDEV)
    tiny = dist_mod.DistConfig(
        num_devices=plan.num_devices,
        tile_rows_per_device=plan.tile_rows_per_device,
        local_capacity=plan.local_capacity,
        slab_capacity=64,  # far below the hot tile's element count
        strip_capacity=plan.strip_capacity,
    )
    fn = dist_mod.make_distributed_render(mesh, CONFIG, tiny)
    view, proj = cam.matrices()
    img, _dropped = fn(
        jax.tree.map(jnp.asarray, padded),
        jnp.asarray(view),
        jnp.asarray(proj),
        jnp.asarray(cam.position, dtype=jnp.float32),
    )
    img = np.asarray(img)[: CONFIG.height, : CONFIG.width]
    assert np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0


def test_hot_tile_exceeding_slab_renders_without_drops():
    """A tile holding >2x slab_capacity elements must
    render equal to single-device instead of dropping.  The depth-banded
    exchange splits every tile's range over all devices, so per-slab load is
    ~1/ndev of a device's elements regardless of tile skew."""
    from vk3dgaussiansplatting_tpu.ops import keygen as keygen_ops
    from vk3dgaussiansplatting_tpu.ops import ranges as ranges_ops
    from vk3dgaussiansplatting_tpu.ops import sort as sort_ops

    table = _hot_cloud()
    cam = _camera()

    # Single-device reference + its hottest tile's range length.
    renderer = Renderer(CONFIG, use_pallas_blend=False)
    renderer.init_for_scene(table)
    out = renderer.draw(cam)
    ref = np.asarray(out.image)
    ref_count = int(out.num_elements)
    view, proj = cam.matrices()
    cap = CONFIG.sort_capacity(table.num_gaussians)
    els, _ = keygen_ops.generate_sort_elements(
        jax.tree.map(jnp.asarray, table),
        jnp.asarray(view), jnp.asarray(proj),
        jnp.asarray(cam.position, dtype=jnp.float32),
        CONFIG, cap,
    )
    els = sort_ops.sort_elements(els, CONFIG)
    rngs = np.asarray(ranges_ops.find_ranges(els, CONFIG.num_tiles))
    hottest = int((rngs[:, 1] - rngs[:, 0]).max())
    assert hottest > 8, "fixture no longer produces a hot tile"

    # Slab sized so the hot tile alone is >2x slab capacity.
    slab = max(hottest // 2 - 1, 8)
    assert hottest > 2 * slab

    mesh = make_mesh(NDEV)
    padded = dist_mod._pad_table(table, NDEV)
    plan = dist_mod.plan_distribution(CONFIG, padded.num_gaussians, NDEV)
    tiny = dist_mod.DistConfig(
        num_devices=plan.num_devices,
        tile_rows_per_device=plan.tile_rows_per_device,
        local_capacity=plan.local_capacity,
        slab_capacity=slab,
        # keep the full-strip window: this test isolates SLAB overflow
        strip_capacity=plan.strip_capacity,
    )
    fn = dist_mod.make_distributed_render(mesh, CONFIG, tiny, return_stats=True)
    img, acct = fn(
        jax.tree.map(jnp.asarray, padded),
        jnp.asarray(view),
        jnp.asarray(proj),
        jnp.asarray(cam.position, dtype=jnp.float32),
    )
    img = np.asarray(img)[: CONFIG.height, : CONFIG.width]
    acct = np.asarray(acct).reshape(-1, 4)
    # No element was dropped anywhere (exact integer accounting)...
    blended = int((acct[:, 2] - acct[:, 3]).sum())
    assert blended == ref_count
    # ...the accounting chain balances (local == sent == received)...
    assert int(acct[:, 0].sum()) == int(acct[:, 1].sum()) == ref_count
    # ...and the image matches single-device within the float contract.
    np.testing.assert_allclose(img, ref, atol=2e-3)


def test_strip_window_overflow_is_reported():
    """An under-sized per-phase strip window must not
    fail silently — the default return surfaces the dropped-element count,
    and the drop counter is the only divergence signal (the image stays
    finite and only ever loses elements)."""
    table = _hot_cloud()
    cam = _camera()

    mesh = make_mesh(NDEV)
    padded = dist_mod._pad_table(table, NDEV)
    plan = dist_mod.plan_distribution(CONFIG, padded.num_gaussians, NDEV)
    tiny = dist_mod.DistConfig(
        num_devices=plan.num_devices,
        tile_rows_per_device=plan.tile_rows_per_device,
        local_capacity=plan.local_capacity,
        slab_capacity=plan.slab_capacity,
        strip_capacity=8,  # far below the hot strip's element count
    )
    fn = dist_mod.make_distributed_render(mesh, CONFIG, tiny)
    view, proj = cam.matrices()
    img, dropped = fn(
        jax.tree.map(jnp.asarray, padded),
        jnp.asarray(view),
        jnp.asarray(proj),
        jnp.asarray(cam.position, dtype=jnp.float32),
    )
    img = np.asarray(img)[: CONFIG.height, : CONFIG.width]
    assert int(np.sum(np.asarray(dropped))) > 0  # overflow is visible
    assert np.isfinite(img).all()  # ...and degrades, never corrupts
