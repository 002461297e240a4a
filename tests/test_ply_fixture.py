"""End-to-end test over the committed real-format .ply fixture.

The fixture (tests/fixtures/gs_export_384.ply, built by
scripts/make_ply_fixture.py) reproduces the INRIA-3DGS export layout the
reference loads for its benchmark scenes (GardenScene.cpp:15 →
ResourceManager.cpp:167-300): binary_little_endian, normals present (and
skipped by name), channel-major f_rest, pre-activation values.  This drives
the exact path the synthetic-writer tests cannot: a foreign property order
with extra columns, through load_gaussians (Python and native readers) to
an image-parity check against a committed golden.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from vk3dgaussiansplatting_tpu.io import ply
from vk3dgaussiansplatting_tpu.io.ply import load_gaussians
from vk3dgaussiansplatting_tpu.native import runtime

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "gs_export_384.ply"
GOLDEN = Path(__file__).resolve().parent / "golden" / "ply_fixture.png"

CONFIG_KW = dict(width=192, height=96, capacity_slack_per_tile=32)


def _render(table):
    from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
    from vk3dgaussiansplatting_tpu.pipeline import Renderer
    from vk3dgaussiansplatting_tpu.render.camera import Camera

    config = RenderConfig(sort_algorithm=SortAlgorithm.XLA_SORT, **CONFIG_KW)
    cam = Camera(config.aspect)
    cam.set_position((0.0, 0.0, 2.5))
    cam.set_rotation(np.pi, 0.0)
    renderer = Renderer(config, use_pallas_blend=False)
    renderer.init_for_scene(table)
    return renderer.draw_numpy(cam)


def test_fixture_is_reproducible(tmp_path):
    """The committed file matches its generator byte-for-byte."""
    script = FIXTURE.parent.parent.parent / "scripts" / "make_ply_fixture.py"
    out = tmp_path / "regen.ply"
    import sys

    env_src = script.read_text().replace(
        'OUT = os.path.join(\n    os.path.dirname(__file__), "..", "tests", "fixtures", "gs_export_384.ply"\n)',
        f'OUT = r"{out}"',
    )
    exec_path = tmp_path / "gen.py"
    exec_path.write_text(env_src)
    import os

    env = dict(os.environ, PYTHONPATH=str(FIXTURE.parent.parent.parent))
    subprocess.run([sys.executable, str(exec_path)], check=True, env=env)
    assert out.read_bytes() == FIXTURE.read_bytes()


def test_loader_skips_normals_and_reads_all_59_columns():
    raw = ply.read_ply(FIXTURE)
    el = raw.element()
    names = [p[0] for p in el.properties]
    assert names[:6] == ["x", "y", "z", "nx", "ny", "nz"]
    assert names[6:9] == ["f_dc_0", "f_dc_1", "f_dc_2"]
    assert names[-7:] == [
        "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3",
    ]
    cols = ply.gaussian_columns_from_ply(FIXTURE)
    assert cols["xyz"].shape == (384, 3)
    assert cols["f_rest"].shape == (384, 45)


def test_activation_transforms_applied():
    table = load_gaussians(FIXTURE)
    raw = ply.read_ply(FIXTURE).element()
    # x/y negation (ResourceManager.cpp:231-236) — Morton sort permutes rows,
    # so compare as multisets.
    assert table.position.shape == (384, 3)
    np.testing.assert_allclose(
        np.sort(np.asarray(table.position[:, 0])),
        np.sort(-raw.column("x")),
        rtol=1e-6,
    )
    # exp / sigmoid activations land in their ranges
    assert (np.asarray(table.scale) > 0).all()
    assert ((np.asarray(table.opacity) > 0) & (np.asarray(table.opacity) < 1)).all()
    # quaternions normalized
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(table.rot), axis=1), 1.0, atol=1e-5
    )


def test_native_loader_parity_on_fixture():
    if runtime.get_lib() is None:
        build = Path(runtime.__file__).parent / "build.sh"
        try:
            subprocess.run(["sh", str(build)], check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            pytest.skip("no C++ toolchain available")
        runtime._LIB_TRIED = False
    native = runtime.try_load_gaussians(FIXTURE)
    if native is None:
        pytest.skip("native library unavailable")
    python = ply.gaussian_columns_from_ply(FIXTURE)
    for key in python:
        np.testing.assert_array_equal(native[key], python[key], err_msg=key)


def test_fixture_renders_golden_image():
    from vk3dgaussiansplatting_tpu.io.image import read_png

    table = load_gaussians(FIXTURE)
    got = _render(table)
    assert (got[..., :3].sum(-1) > 0).sum() > 100, "fixture renders nothing"
    assert GOLDEN.exists(), (
        f"missing golden {GOLDEN}; run: python -m tests.test_ply_fixture regen"
    )
    want = read_png(GOLDEN)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from vk3dgaussiansplatting_tpu.io.image import write_png

        img = _render(load_gaussians(FIXTURE))
        GOLDEN.parent.mkdir(exist_ok=True)
        write_png(GOLDEN, img)
        print(f"wrote {GOLDEN}")
