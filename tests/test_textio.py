"""The stdlib PNG reader and writer (textio.read_png / write_png) against
Pillow: every colour type the pipeline takes, every row filter, and the
inputs it must refuse."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from text_alignment_tpu.textio import read_png, write_png

H, W = 37, 53


def _img(mode):
    rng = np.random.default_rng(sum(map(ord, mode)))
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    if mode == "1":
        return Image.fromarray(rng.random((H, W)) < 0.5)
    if mode == "L":
        return Image.fromarray(rgb[..., 0])
    if mode == "RGB":
        return Image.fromarray(rgb)
    if mode == "RGBA":
        return Image.fromarray(rng.integers(0, 256, (H, W, 4),
                                            dtype=np.uint8))
    if mode == "LA":
        return Image.fromarray(rgb).convert("LA")
    if mode == "P":
        return Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                            colors=200)
    if mode == "P4":  # 13 colours: a 4-bit palette
        return Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                            colors=13)
    raise ValueError(mode)


@pytest.mark.parametrize("mode", ["1", "L", "RGB", "RGBA", "LA", "P", "P4"])
def test_read_matches_pillow(tmp_path, mode):
    """Grey, grey+alpha, RGB(A) and 1-bit pages read as Pillow's
    np.asarray gives them; palette pages expand to their RGB colours.
    Pillow's encoder picks a filter per row, so random content exercises
    the Average and Paeth rows too."""
    p = str(tmp_path / "x.png")
    im = _img(mode)
    im.save(p)
    got = read_png(p)
    want = np.asarray(Image.open(p).convert("RGB")) if mode.startswith("P") \
        else np.asarray(Image.open(p))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_read_palette_transparency_as_rgba(tmp_path):
    p = str(tmp_path / "t.png")
    _img("P").save(p, transparency=5)
    np.testing.assert_array_equal(
        read_png(p), np.asarray(Image.open(p).convert("RGBA")))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _png(w, h, depth, ctype, raw, interlace=0):
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, interlace))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def test_read_sub_and_up_rows(tmp_path):
    """Rows filtered with None, Sub and Up only take the row-wise path;
    the result is the unfiltered image."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (6, 9, 3), dtype=np.uint8)
    rows = img.reshape(6, 27).astype(np.int32)
    raw = b""
    for y, ft in enumerate([0, 1, 2, 1, 2, 0]):
        r = rows[y].copy()
        if ft == 1:
            r[3:] = rows[y, 3:] - rows[y, :-3]
        elif ft == 2:
            r = rows[y] - rows[y - 1]
        raw += bytes([ft]) + (r & 255).astype(np.uint8).tobytes()
    p = tmp_path / "su.png"
    p.write_bytes(_png(9, 6, 8, 2, raw))
    np.testing.assert_array_equal(read_png(str(p)), img)


def test_read_4bit_grey_scales_to_8bit(tmp_path):
    levels = np.random.default_rng(2).integers(0, 16, (5, 7)).astype(np.uint8)
    packed = np.zeros((5, 4), np.uint8)
    for x in range(7):
        packed[:, x // 2] |= levels[:, x] << (4 if x % 2 == 0 else 0)
    raw = b"".join(b"\x00" + packed[y].tobytes() for y in range(5))
    p = tmp_path / "g4.png"
    p.write_bytes(_png(7, 5, 4, 0, raw))
    np.testing.assert_array_equal(read_png(str(p)), levels * 17)


@pytest.mark.parametrize("kind", ["bool", "L", "RGB", "RGBA"])
def test_write_round_trips_through_pillow(tmp_path, kind):
    rng = np.random.default_rng(3)
    a = {"bool": rng.random((H, W)) < 0.5,
         "L": rng.integers(0, 256, (H, W), dtype=np.uint8),
         "RGB": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
         "RGBA": rng.integers(0, 256, (H, W, 4), dtype=np.uint8)}[kind]
    p = str(tmp_path / "w.png")
    write_png(p, a)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), a)
    np.testing.assert_array_equal(read_png(p), a)


@pytest.mark.parametrize("data", [
    b"GIF89a not a png",
    _png(2, 2, 8, 0, b"\x00\x00\x00\x00\x00\x00", interlace=1),
    _png(2, 2, 16, 2, b"\x00" * 26),
])
def test_read_refuses_unsupported_files(tmp_path, data):
    p = tmp_path / "bad.png"
    p.write_bytes(data)
    with pytest.raises(ValueError):
        read_png(str(p))


def test_write_refuses_unsupported_arrays(tmp_path):
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
