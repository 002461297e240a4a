"""Command-line entry point — the reference's Main.cpp equivalent.

The reference hard-codes its startup scene (Main.cpp:21) and asset paths
(GardenScene.cpp:15); here scenes, resolution, sort algorithm, SH mode and
frame counts are CLI flags (the runtime config system the reference lacks,
SURVEY.md §5 "Config / flag system").

Usage:
  python -m vk3dgaussiansplatting_tpu.app.cli --scene simple --frames 3 \\
      --width 1280 --height 720 --out out.png
  python -m vk3dgaussiansplatting_tpu.app.cli --ply scene.ply --bench
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core.config import RenderConfig, SortAlgorithm, SphericalHarmonicsMode
from ..utils import log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vk3dgs", description="3D gaussian splatting renderer (JAX)"
    )
    p.add_argument(
        "--scene",
        default="simple",
        choices=["simple", "sort", "garden", "train", "bicycle", "procedural"],
        help="synthetic scene or benchmark stand-in",
    )
    p.add_argument("--ply", help="path to a .ply gaussian cloud (overrides --scene)")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--out", help="write last frame PNG here")
    p.add_argument(
        "--sort", default="auto", choices=["auto", "xla", "bitonic"],
        help="sort algorithm (reference: GPU_SORT_ALGORITHM)",
    )
    p.add_argument(
        "--sh-mode", type=int, default=0, choices=[0, 1, 2],
        help="spherical harmonics mode (reference hotkeys 1/2/3)",
    )
    p.add_argument("--gaussians", type=int, default=1_000_000,
                   help="gaussian count for --scene procedural")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-pallas", action="store_true",
                   help="use the XLA blend tier instead of the Pallas kernel")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--slack", type=int, default=None,
                   help="sort-capacity slack per tile (default: reference's 1024)")
    return p


def make_scene(args, aspect):
    from ..scenes import synthetic
    from ..scenes.scene import Scene
    from ..render import camera as cam_mod

    if args.ply:
        class PlyScene(Scene):
            def init(self):
                self.camera.set_position((0.0, 0.0, 2.0))
                self.camera.set_rotation(np.pi, 0.0)
                self.load_gaussians(args.ply)

        return PlyScene(aspect)
    if args.scene == "simple":
        return synthetic.SimpleTestGaussiansScene(aspect)
    if args.scene == "sort":
        return synthetic.TestSortScene(aspect)
    if args.scene == "procedural":
        return synthetic.ProceduralBenchScene(args.gaussians, aspect, args.seed)
    # benchmark stand-ins at reference scales with pinned cameras
    counts = {"garden": 5_834_784, "train": 1_026_508, "bicycle": 1_500_000}
    scene = synthetic.ProceduralBenchScene(counts[args.scene], aspect, args.seed)
    return scene


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    sort = {
        "auto": SortAlgorithm.AUTO,
        "xla": SortAlgorithm.XLA_SORT,
        "bitonic": SortAlgorithm.BITONIC,
    }[args.sort]
    kwargs = {}
    if args.slack is not None:
        kwargs["capacity_slack_per_tile"] = args.slack
    config = RenderConfig(
        width=args.width,
        height=args.height,
        sort_algorithm=sort,
        sh_mode=SphericalHarmonicsMode(args.sh_mode),
        **kwargs,
    )

    from .engine import Engine

    engine = Engine(config, use_pallas_blend=not args.no_pallas if not args.cpu else False)
    scene = make_scene(args, config.aspect)
    engine.init(scene)

    frames = {}

    def on_frame(i, img):
        frames["last"] = img

    engine.run(args.frames, on_frame=on_frame)
    if args.out and "last" in frames:
        from ..io.image import write_png

        write_png(args.out, frames["last"])
        log.write(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
