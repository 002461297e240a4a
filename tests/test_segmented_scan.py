"""The XLA tier's segmented cumsum (ops/blend.py): exact restart at every
segment, across chunk boundaries, and per-segment f32 precision however
long the list (the property the garden-scale reference relies on)."""

import jax.numpy as jnp
import numpy as np
import pytest

from vk3dgaussiansplatting_tpu.ops.blend import SCAN_CHUNK, segmented_cumsum


def _reference(x, first):
    out = np.zeros_like(x, dtype=np.float64)
    acc = np.zeros(x.shape[1:])
    for i in range(x.shape[0]):
        if first[i]:
            acc = np.zeros(x.shape[1:])
        acc = acc + x[i]
        out[i] = acc
    return out


@pytest.mark.parametrize(
    "e", [1, SCAN_CHUNK - 1, SCAN_CHUNK, SCAN_CHUNK + 1, 1000, 40_000]
)
def test_segmented_cumsum_matches_sequential(e):
    rng = np.random.default_rng(e)
    x = rng.normal(size=(e, 3)).astype(np.float32)
    first = rng.random(e) < 0.01
    first[0] = rng.random() < 0.5  # a list need not start with a flag
    got = np.asarray(segmented_cumsum(jnp.asarray(x), jnp.asarray(first)))
    np.testing.assert_allclose(got, _reference(x, first), atol=5e-5)


def test_long_list_keeps_segment_precision():
    """Large-magnitude segments before a small one: a global cumsum rebased
    at the segment start would lose the small segment to cancellation."""
    e = 20 * SCAN_CHUNK
    x = np.full((e, 1), -50.0, np.float32)
    first = np.zeros(e, bool)
    first[::200] = True
    tail = e - 37
    first[tail] = True
    x[tail:] = 1e-3
    got = np.asarray(segmented_cumsum(jnp.asarray(x), jnp.asarray(first)))
    want = np.cumsum(x[tail:, 0].astype(np.float64))
    np.testing.assert_allclose(got[tail:, 0], want, rtol=1e-5)
