"""Frame pipeline — the reference `Renderer` re-imagined as a jitted program.

The reference Renderer (Engine/Graphics/Renderer.{h,cpp}) owns Vulkan objects,
sizes GPU buffers per scene (initForScene, Renderer.cpp:712-756) and records a
9-pass command buffer each frame (recordCommandBuffer, Renderer.cpp:540-629).
Here the frame is one jitted function for every scene size: barriers are
implicit in SSA dataflow, buffer lifetimes are XLA's problem, indirect
dispatch becomes static capacity + masks, and the three frames-in-flight
(GfxSettings.h:15) fall out of JAX's async dispatch.

    keygen (cull + keys + SH)  ->  sort  ->  find_ranges  ->  blend

`Renderer.init_for_scene` plays the role of the reference's initForScene:
fixes the static capacity (the same `ceilPow2(N + 64*16*tiles)` formula,
Renderer.cpp:725) and uploads the gaussian table once (`device_put` — the
staging-buffer copy, Buffer.cpp:74-108).  The blend tier comes from the one
platform decision in utils/device.py: the tile-blend kernel on a GPU, the
XLA tier on the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .core.config import RenderConfig
from .models.gaussians import GaussianTable
from .ops import blend as blend_ops
from .ops import keygen as keygen_ops
from .ops import ranges as ranges_ops
from .ops import sort as sort_ops
from .utils import device


class FrameOutputs(NamedTuple):
    """One rendered frame plus inspection intermediates."""

    image_u8: jax.Array  # [H, W, 4] uint8 (rgba, the swapchain image)
    image: jax.Array  # [H, W, 3] float32 pre-quantization
    num_elements: jax.Array  # [] uint32 live sort elements


@functools.partial(
    jax.jit, static_argnames=("config", "capacity", "use_pallas_blend")
)
def render_frame(
    table: GaussianTable,
    view,
    proj,
    cam_pos,
    *,
    config: RenderConfig,
    capacity: int,
    use_pallas_blend: bool = False,
) -> FrameOutputs:
    """The full 9-pass frame as one XLA program.

    ``use_pallas_blend`` selects the tile-blend kernel (ops/pallas), else
    the XLA tier.  The gaussian table is an argument, never a constant."""
    elements, frame = keygen_ops.generate_sort_elements(
        table, view, proj, cam_pos, config, capacity
    )
    elements = sort_ops.sort_elements(elements, config)
    ranges = ranges_ops.find_ranges(elements, config.num_tiles)
    if use_pallas_blend:
        from .ops.pallas import blend_kernel

        image = blend_kernel.blend_tiles_kernel(elements, ranges, frame, config)
    else:
        image = blend_ops.blend_tiles_xla(elements, ranges, frame, config)
    return FrameOutputs(
        image_u8=blend_ops.quantize_image(image),
        image=image,
        num_elements=elements.count,
    )


class Renderer:
    """Scene-bound renderer (reference: Renderer + initForScene)."""

    def __init__(
        self,
        config: RenderConfig,
        *,
        use_pallas_blend: bool | None = None,
    ):
        self.config = config
        if use_pallas_blend is None:
            use_pallas_blend = device.blend_uses_kernel()
        self.use_pallas_blend = use_pallas_blend
        self.table: GaussianTable | None = None
        self.capacity: int | None = None

    def init_for_scene(self, table: GaussianTable) -> None:
        """Upload the gaussian table and fix static sizes (Renderer.cpp:712)."""
        self.capacity = self.config.sort_capacity(table.num_gaussians)
        self.table = jax.device_put(
            GaussianTable(
                position=jnp.asarray(table.position, dtype=jnp.float32),
                scale=jnp.asarray(table.scale, dtype=jnp.float32),
                rot=jnp.asarray(table.rot, dtype=jnp.float32),
                sh=jnp.asarray(table.sh, dtype=jnp.float32),
                opacity=jnp.asarray(table.opacity, dtype=jnp.float32),
            )
        )

    def draw(self, camera) -> FrameOutputs:
        """Render one frame from a `render.camera.Camera`."""
        if self.table is None:
            raise RuntimeError("call init_for_scene() first")
        view, proj = camera.matrices()
        return render_frame(
            self.table,
            jnp.asarray(view),
            jnp.asarray(proj),
            jnp.asarray(camera.position, dtype=jnp.float32),
            config=self.config,
            capacity=self.capacity,
            use_pallas_blend=self.use_pallas_blend,
        )

    def draw_numpy(self, camera):
        """Render and fetch to host (uint8 rgba)."""
        out = self.draw(camera)
        return np.asarray(out.image_u8)
