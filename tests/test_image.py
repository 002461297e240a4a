"""PNG output without PIL (io/image.py): exact round trips, and decoding
the committed goldens, whose scanlines use PNG's adaptive filters."""

import zlib
from pathlib import Path

import numpy as np
import pytest

from vk3dgaussiansplatting_tpu.io.image import read_png, write_png

GOLDEN = Path(__file__).resolve().parent / "golden"


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53, channels)).astype(np.uint8)
    path = tmp_path / "f.png"
    write_png(path, img)
    assert path.read_bytes().startswith(b"\x89PNG\r\n\x1a\n")
    np.testing.assert_array_equal(read_png(path), img)


def test_png_rejects_non_uint8(tmp_path):
    with pytest.raises(TypeError):
        write_png(tmp_path / "f.png", np.zeros((4, 4, 3), np.float32))


def test_goldens_decode_with_filters():
    """The goldens were written by an encoder that picks a filter per
    scanline; decoding must undo every filter type they use."""
    for name in ("simple", "sort", "ply_fixture"):
        img = read_png(GOLDEN / f"{name}.png")
        assert img.shape == (96, 192, 4) and img.dtype == np.uint8
        assert (img[..., 3] == 255).all()
        assert img[..., :3].max() > 0
    blob = (GOLDEN / "sort.png").read_bytes()
    start = blob.index(b"IDAT") + 4
    length = int.from_bytes(blob[start - 8:start - 4], "big")
    raw = zlib.decompress(blob[start:start + length])
    filters = {raw[y * (192 * 4 + 1)] for y in range(96)}
    assert len(filters) > 1, filters
