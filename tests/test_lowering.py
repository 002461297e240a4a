"""CUDA lowering gate: every tile-blend kernel entry point cross-lowers for
the GPU at garden30k_1080p shapes, on the CPU, with no card.

Interpret-mode tests never run the Triton lowering, so a kernel change
that the GPU route cannot lower would otherwise show only on the card.
`jax.export` lowers for the "cuda" platform from abstract shapes (no data
is allocated); the Triton custom call is allowed explicitly.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
from jax import export

from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.ops.keygen import GaussianFrameData, SortElements
from vk3dgaussiansplatting_tpu.ops.pallas import blend_kernel

N = 5_834_784
CONFIG = RenderConfig(
    width=1920, height=1080, capacity_pow_two=False,
    sort_algorithm=SortAlgorithm.XLA_SORT,
)
E = CONFIG.sort_capacity(N)
T = CONFIG.num_tiles
P = CONFIG.tile_size ** 2
S = jax.ShapeDtypeStruct
ELEMENTS = SortElements(
    S((E,), jnp.uint32), S((E,), jnp.uint32), S((E,), jnp.uint32),
    S((), jnp.uint32),
)
FRAME = GaussianFrameData(
    S((N, 4), jnp.float32), S((N, 3), jnp.float32), S((N, 3), jnp.float32),
    S((N, 2), jnp.float32),
)
RANGES = S((T, 2), jnp.uint32)
STRIP = CONFIG.grid_width * 17  # one of four bands of tile rows


def _tiles(batch):
    fn = functools.partial(
        blend_kernel.blend_tiles_kernel, config=CONFIG, batch=batch,
        interpret=False,
    )
    return fn, (ELEMENTS, RANGES, FRAME)


def _strip_indexed():
    def fn(el, rg, fr, base, cc, cl):
        return blend_kernel.blend_strip_colors_kernel(
            el, rg, fr, CONFIG, tile_base=base, num_strip_tiles=STRIP,
            carry_color=cc, carry_logt=cl, interpret=False,
        )

    return fn, (
        ELEMENTS, RANGES, FRAME, S((), jnp.int32),
        S((STRIP, P, 3), jnp.float32), S((STRIP, P), jnp.float32),
    )


def _strip_routed():
    def fn(el, rg, sp, ca, ci, cc, cl):
        return blend_kernel.blend_strip_colors_kernel(
            el, rg, None, CONFIG, tile_base=0, num_strip_tiles=STRIP,
            carry_color=cc, carry_logt=cl, features=(sp, ca, ci),
            interpret=False,
        )

    return fn, (
        ELEMENTS, RANGES, S((E, 2), jnp.float32), S((E, 4), jnp.float32),
        S((E, 3), jnp.float32), S((STRIP, P, 3), jnp.float32),
        S((STRIP, P), jnp.float32),
    )


ENTRY_POINTS = {
    "blend_tiles_kernel_batch8": functools.partial(_tiles, 8),
    "blend_tiles_kernel_batch16": functools.partial(_tiles, 16),
    "blend_strip_colors_kernel_indexed": _strip_indexed,
    "blend_strip_colors_kernel_routed": _strip_routed,
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_kernel_lowers_for_cuda(entry):
    fn, args = ENTRY_POINTS[entry]()
    exp = export.export(
        jax.jit(fn),
        platforms=["cuda"],
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(*args)
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    assert "tile_blend" in text
