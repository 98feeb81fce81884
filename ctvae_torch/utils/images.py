"""Image grids and PNG files (the torchvision ``save_image`` analogue).

Counterpart of ``ctvae_tpu/utils/images.py``. Images are NHWC float in
[0, 1]. PNGs are written and read with ``zlib`` and ``struct`` of the
standard library, so they need no imaging package: ``read_png`` decodes
every colour type, bit depth, filter and the Adam7 interlace of the PNG
specification to uint8 RGB, as PIL's ``Image.open(f).convert("RGB")``
gives them (the JAX package's OxfordPets loader).
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 12, padding: int = 2,
              pad_value: float = 0.0, normalize: bool = False) -> np.ndarray:
    """Tile [B, H, W, C] into one [H', W', C] grid, ``nrow`` images per row.

    ``normalize=True`` min-max rescales the whole batch to [0, 1]."""
    images = np.asarray(images, dtype=np.float32)
    if images.ndim == 3:  # single image
        images = images[None]
    if images.shape[-1] not in (1, 3, 4):  # NCHW slipped in; transpose
        images = np.transpose(images, (0, 2, 3, 1))
    if normalize:
        lo, hi = images.min(), images.max()
        images = (images - lo) / max(hi - lo, 1e-8)
    b, h, w, c = images.shape
    nrow = max(1, min(nrow, b))
    ncol = math.ceil(b / nrow)
    grid = np.full((ncol * (h + padding) + padding,
                    nrow * (w + padding) + padding, c),
                   pad_value, dtype=np.float32)
    for i in range(b):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return grid


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img, np.float32) * 255.0 + 0.5,
                   0, 255).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(arr: np.ndarray) -> bytes:
    """An 8-bit PNG of ``arr`` uint8 [H, W] (grey), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA): one IDAT of unfiltered scanlines."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w = arr.shape[:2]
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[-1] in (3, 4):
        color = 2 if arr.shape[-1] == 3 else 6
    else:
        raise ValueError(f"no PNG colour type for shape {arr.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)],
                          axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_image(images: np.ndarray, path: str, nrow: int = 12,
               padding: int = 2, normalize: bool = False) -> None:
    """Save a batch as a PNG grid."""
    arr = to_uint8(make_grid(images, nrow=nrow, padding=padding,
                             normalize=normalize))
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(arr))


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel, and the bit depths allowed, of each colour type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(data: bytes):
    """(tag, body) of each chunk through IEND, each CRC checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (no PNG signature)")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated before its IEND chunk")
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"chunk {tag!r} truncated")
        body = data[pos + 8:end]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[end:end + 4])[0]:
            raise ValueError(f"broken CRC in chunk {tag!r}")
        yield tag, body
        if tag == b"IEND":
            return
        pos = end + 4


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Scanlines [n, 1 + stride] (filter byte first) -> bytes [n, stride].
    A byte depends on the byte ``bpp`` to its left and the two above, so
    the pixels of one anti-diagonal (x + y constant) are independent: the
    image is unfiltered one diagonal at a time, every row's filter at
    once, in n + stride / bpp vector steps."""
    n, stride = rows.shape[0], rows.shape[1] - 1
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise ValueError(f"unknown filter type {int(kinds[kinds > 4][0])}")
    width = stride // bpp
    raw = rows[:, 1:].reshape(n, width, bpp).astype(np.int16)
    # a zero row above and a zero pixel left of the image
    out = np.zeros((n + 1, width + 1, bpp), np.int16)
    for d in range(n + width - 1):
        ys = np.arange(max(0, d - width + 1), min(n, d + 1))
        xs = d - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = kinds[ys, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (raw[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(n, stride)


def _samples(rows: np.ndarray, width: int, channels: int,
             depth: int) -> np.ndarray:
    """Unfiltered bytes [n, stride] -> samples [n, width, channels]
    (uint16 at depth 16, else uint8 of the raw sample values)."""
    n = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(n, width, channels)
    if depth == 16:
        pairs = rows[:, :width * channels * 2].reshape(n, -1, 2)
        wide = (pairs[..., 0].astype(np.uint16) << 8) | pairs[..., 1]
        return wide.reshape(n, width, channels)
    bits = np.unpackbits(rows, axis=1).reshape(n, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    values = (bits * weights).sum(axis=2, dtype=np.uint8)
    return values[:, :width, None]


def png_rgb(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> uint8 [H, W, 3], PIL's ``convert("RGB")`` of
    it: grey at depth 1 / 2 / 4 scaled to 0..255 (x255 / x85 / x17), at
    depth 16 clipped to 255 (PIL's 16-bit grey converts by value); the
    other colour types at depth 16 keep each sample's high byte; a
    palette index past PLTE is black; alpha and tRNS are dropped. Raises
    ValueError on a broken CRC, zlib stream or header."""
    header, palette, idat = None, None, []
    for tag, body in _png_chunks(data):
        if tag == b"IHDR":
            if len(body) != 13:
                raise ValueError("IHDR is not 13 bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("no IHDR chunk")
    width, height, depth, color, method, filt, interlace = header
    if color not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"colour type {color} at bit depth {depth} is not "
                         f"in the PNG specification")
    if method or filt or interlace not in (0, 1) or not width or not height:
        raise ValueError(f"unknown IHDR fields {header}")
    if color == 3 and palette is None:
        raise ValueError("a palette image without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"broken zlib stream in IDAT: {e}") from None
    channels = _PNG_CHANNELS[color]
    bits = channels * depth
    bpp = max(1, bits // 8)
    image = np.zeros((height, width, channels),
                     np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        w = (width - x0 + dx - 1) // dx
        h = (height - y0 + dy - 1) // dy
        if w <= 0 or h <= 0:
            continue
        stride = (w * bits + 7) // 8
        block = raw[pos:pos + h * (stride + 1)]
        if len(block) < h * (stride + 1):
            raise ValueError(f"image data ends {h * (stride + 1) - len(block)}"
                             f" bytes short")
        pos += len(block)
        rows = np.frombuffer(block, np.uint8).reshape(h, stride + 1)
        image[y0::dy, x0::dx] = _samples(_unfilter(rows, bpp), w, channels,
                                         depth)
    if color == 3:
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[image[..., 0]]
    if depth == 16:
        image = (np.minimum(image, 255) if color == 0
                 else image >> 8).astype(np.uint8)
    elif depth < 8:
        image = image * np.uint8(255 // ((1 << depth) - 1))
    grey = color in (0, 4)
    return np.repeat(image[..., :1], 3, axis=2) if grey else \
        np.ascontiguousarray(image[..., :3])


def read_png(path: str) -> np.ndarray:
    """The PNG file at ``path`` -> uint8 [H, W, 3] (``png_rgb``); a file
    that does not decode raises ValueError naming it."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return png_rgb(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
