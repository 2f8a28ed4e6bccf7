"""Plaintext transcript reading, OCR character cleanup, and PNG page I/O.

Reference semantics: alignToOCR.py:61-87.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def clean_special_chars(inp: str) -> str:
    """Remove special characters from OCR output (reference: alignToOCR.py:61-72)."""
    return inp.replace("~", "")


def read_file(fname: str) -> str:
    """Read a plaintext transcript of a manuscript page.

    Joins non-comment lines with spaces, strips newlines and "| " separators
    (reference: alignToOCR.py:75-87).
    """
    with open(fname, "r") as f:
        lines = f.readlines()
    lines = " ".join(x for x in lines if not x[0] == "#")
    lines = lines.replace("\n", "")
    lines = lines.replace("\r", "")
    lines = lines.replace("| ", "")
    return lines


# ---------------------------------------------------------------------------
# PNG (zlib + struct only: page images need no imaging library)
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG has no IEND chunk")


def _png_unfilter(raw: bytes, H: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth).
    Returns the (H, rowbytes) uint8 scanlines."""
    f = np.frombuffer(raw, np.uint8)
    if f.size < H * (rowbytes + 1):
        raise ValueError("truncated PNG image data")
    f = f[:H * (rowbytes + 1)].reshape(H, rowbytes + 1)
    ft = f[:, 0].astype(np.int32)
    if ft.max(initial=0) > 4:
        raise ValueError("bad PNG filter type")
    npx = rowbytes // bpp
    X = f[:, 1:].astype(np.int32).reshape(H, npx, bpp)
    # O[y + 1, x + 1] = reconstructed pixel (y, x); row 0 and column 0
    # are the zero neighbours the filters see outside the image
    O = np.zeros((H + 1, npx + 1, bpp), np.int32)
    if ft.max(initial=0) <= 2:
        # None / Sub / Up rows: row-wise, Sub as a prefix sum mod 256
        for y in range(H):
            if ft[y] == 1:
                O[y + 1, 1:] = np.cumsum(X[y], axis=0) & 255
            elif ft[y] == 2:
                O[y + 1, 1:] = (X[y] + O[y, 1:]) & 255
            else:
                O[y + 1, 1:] = X[y]
        return O[1:, 1:].reshape(H, rowbytes).astype(np.uint8)
    # Average / Paeth depend on the reconstructed left neighbour, so the
    # decode walks anti-diagonals: pixel (y, x) needs only (y, x-1),
    # (y-1, x) and (y-1, x-1), all on earlier diagonals
    ys = np.arange(H)
    for d in range(H + npx - 1):
        y = ys[max(0, d - npx + 1):min(H, d + 1)]
        x = d - y
        a = O[y + 1, x]
        b = O[y, x + 1]
        c = O[y, x]
        t = ft[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 0, t == 1, t == 2, t == 3],
                         [0, a, b, (a + b) >> 1], paeth)
        O[y + 1, x + 1] = (X[y, x] + pred) & 255
    return O[1:, 1:].reshape(H, rowbytes).astype(np.uint8)


def read_png(path) -> np.ndarray:
    """Decode a non-interlaced PNG into a numpy array.

    Grey images of 1 bit come back as bool (H, W) (True = white), of 2, 4
    or 8 bits as uint8 (H, W) scaled to 0-255; grey+alpha as (H, W, 2),
    RGB as (H, W, 3) and RGBA as (H, W, 4) uint8 — what
    ``np.asarray(PIL.Image.open(path))`` gives. Palette images are
    expanded to RGB, or RGBA when the file carries transparency.
    """
    with open(path, "rb") as fh:
        data = fh.read()
    header = None
    palette = trns = None
    idat = []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    W, H, depth, ctype, _comp, _filt, interlace = header
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"bad PNG colour type {ctype}")
    ch = _PNG_CHANNELS[ctype]
    if depth not in ((1, 2, 4, 8) if ctype in (0, 3) else (8,)):
        raise ValueError(f"unsupported PNG bit depth {depth} for colour "
                         f"type {ctype}")
    rowbytes = (W * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    rows = _png_unfilter(zlib.decompress(b"".join(idat)), H, rowbytes, bpp)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :W * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits.reshape(H, W, depth) * weights).sum(
            axis=2, dtype=np.uint8)
    else:
        samples = rows.reshape(H, W, ch) if ch > 1 else rows
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[:len(trns)] = trns[:len(palette)]
            palette = np.concatenate([palette, alpha[:, None]], axis=1)
        return palette[np.minimum(samples, len(palette) - 1)]
    if ctype == 0 and depth == 1:
        return samples.astype(bool)
    if ctype == 0 and depth < 8:
        return (samples * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return samples


def write_png(path, img) -> None:
    """Encode a bool (1-bit grey, True = white), uint8 (H, W) grey,
    (H, W, 3) RGB or (H, W, 4) RGBA array as a PNG file."""
    a = np.asarray(img)
    if a.ndim == 2 and a.dtype == bool:
        depth, ctype = 1, 0
        rows = np.packbits(a, axis=1)
    elif a.dtype == np.uint8 and (a.ndim == 2
                                  or (a.ndim == 3 and a.shape[2] in (3, 4))):
        depth, ctype = 8, (0 if a.ndim == 2 else {3: 2, 4: 6}[a.shape[2]])
        rows = a.reshape(a.shape[0], -1)
    else:
        raise ValueError(f"cannot write a {a.dtype} array of shape "
                         f"{a.shape} as PNG")
    H, W = a.shape[:2]
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(_PNG_SIGNATURE
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth,
                                              ctype, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                 + chunk(b"IEND", b""))


def pillow():
    """The Pillow package, for the optional overlay renderer and gtedit.
    Alignment and serving read and write pages without it."""
    try:
        import PIL.Image
        import PIL.ImageDraw
        import PIL.ImageFont
    except ImportError as e:
        raise ImportError(
            "this feature draws images and needs Pillow (pip install "
            "Pillow); page alignment itself does not") from e
    return PIL
