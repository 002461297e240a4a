"""vk3dgaussiansplatting_tpu — a JAX 3D Gaussian Splatting renderer.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
SiTronXD/vk3dGaussianSplatting (a C++/Vulkan real-time 3DGS renderer): load
pre-trained .ply gaussian scenes and execute the 9-pass compute pipeline
(cull + 64-bit keygen with SH color, tile+depth element sort, segmented
group-by ranges, tiled front-to-back alpha blend) as one jitted frame program
on an NVIDIA GPU, scaling over device meshes via shard_map.  See SURVEY.md for the
reference analysis this build follows.
"""

from .core.config import RenderConfig, SortAlgorithm, SphericalHarmonicsMode
from .models.gaussians import GaussianTable
from .pipeline import Renderer, render_frame
from .render.camera import Camera

__all__ = [
    "Camera",
    "GaussianTable",
    "RenderConfig",
    "Renderer",
    "SortAlgorithm",
    "SphericalHarmonicsMode",
    "render_frame",
]

__version__ = "0.1.0"
