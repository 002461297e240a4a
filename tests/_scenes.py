"""Scenes shared by the blend-kernel tests: name -> (table, camera) at an
aspect ratio.  Cameras follow the tests that introduced each scene."""

from pathlib import Path

import numpy as np

from vk3dgaussiansplatting_tpu.models.gaussians import NUM_SH_COEFFS, GaussianTable
from vk3dgaussiansplatting_tpu.render.camera import Camera

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "gs_export_384.ply"

SCENE_NAMES = ("simple", "sort", "ply_fixture", "skewed", "cloud1", "cloud2")


def _camera(aspect, z):
    cam = Camera(aspect)
    cam.set_position((0.0, 0.0, z))
    cam.set_rotation(np.pi, 0.0)
    return cam


def hot_cloud(n=400, seed=11):
    """Gaussians clustered into a tiny screen region (a few hot tiles)."""
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [
            rng.normal(0.0, 0.02, n),
            rng.normal(0.0, 0.01, n),
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


def make_scene(name, aspect):
    from vk3dgaussiansplatting_tpu.scenes.synthetic import (
        SimpleTestGaussiansScene,
        TestSortScene,
        procedural_cloud_table,
    )

    if name in ("simple", "sort"):
        cls = SimpleTestGaussiansScene if name == "simple" else TestSortScene
        scene = cls(aspect=aspect)
        scene.init()
        scene.camera.set_aspect(aspect)
        return scene.gaussians(), scene.camera
    if name == "ply_fixture":
        from vk3dgaussiansplatting_tpu.io.ply import load_gaussians

        return load_gaussians(str(FIXTURE)), _camera(aspect, 2.5)
    if name == "skewed":
        return hot_cloud(), _camera(aspect, 0.5)
    seed = {"cloud1": 1, "cloud2": 2}[name]
    table = procedural_cloud_table(
        512, seed=seed, extent=3.0, scale_log_mean=-2.5
    )
    return table, _camera(aspect, 5.0)


def sorted_frame(table, camera, config):
    """keygen -> sort -> ranges on the current backend:
    (sorted elements, ranges, frame data)."""
    import jax
    import jax.numpy as jnp

    from vk3dgaussiansplatting_tpu.ops import keygen
    from vk3dgaussiansplatting_tpu.ops import ranges as ranges_ops
    from vk3dgaussiansplatting_tpu.ops import sort as sort_ops

    t = jax.tree.map(jnp.asarray, table)
    view, proj = camera.matrices()
    capacity = config.sort_capacity(int(t.position.shape[0]))

    @jax.jit
    def passes(t, view, proj, cam_pos):
        el, fr = keygen.generate_sort_elements(
            t, view, proj, cam_pos, config, capacity
        )
        el = sort_ops.sort_elements(el, config)
        return el, ranges_ops.find_ranges(el, config.num_tiles), fr

    return passes(
        t,
        jnp.asarray(view),
        jnp.asarray(proj),
        jnp.asarray(camera.position, dtype=jnp.float32),
    )
