"""Golden-image regression tests.

Renders the two reference fixture scenes at a pinned config and compares
against committed golden PNGs byte-for-byte (CPU XLA is deterministic).
Regenerate after an *intentional* rendering change with:
    python -m tests.test_golden regen
"""

import os
import sys
from pathlib import Path

import numpy as np

GOLDEN_DIR = Path(__file__).resolve().parent / "golden"

CONFIG_KW = dict(width=192, height=96, capacity_slack_per_tile=32)


def _render(scene_cls):
    from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
    from vk3dgaussiansplatting_tpu.pipeline import Renderer

    config = RenderConfig(sort_algorithm=SortAlgorithm.XLA_SORT, **CONFIG_KW)
    scene = scene_cls(aspect=config.aspect)
    scene.init()
    scene.camera.set_aspect(config.aspect)
    renderer = Renderer(config, use_pallas_blend=False)
    renderer.init_for_scene(scene.gaussians())
    return renderer.draw_numpy(scene.camera)


def _scenes():
    from vk3dgaussiansplatting_tpu.scenes.synthetic import (
        SimpleTestGaussiansScene,
        TestSortScene,
    )

    return {
        "simple": SimpleTestGaussiansScene,
        "sort": TestSortScene,
    }


def test_golden_images():
    from vk3dgaussiansplatting_tpu.io.image import read_png

    for name, cls in _scenes().items():
        path = GOLDEN_DIR / f"{name}.png"
        assert path.exists(), f"missing golden {path}; run: python -m tests.test_golden regen"
        want = read_png(path)
        got = _render(cls)
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, (
            f"golden mismatch for {name}: max diff {diff.max()} "
            f"at {np.unravel_index(diff.argmax(), diff.shape)}"
        )


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax

        jax.config.update("jax_platforms", "cpu")
        from vk3dgaussiansplatting_tpu.io.image import write_png

        GOLDEN_DIR.mkdir(exist_ok=True)
        for name, cls in _scenes().items():
            img = _render(cls)
            write_png(GOLDEN_DIR / f"{name}.png", img)
            print("wrote", GOLDEN_DIR / f"{name}.png")
