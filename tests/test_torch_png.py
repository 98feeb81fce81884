"""The port's PNG reader (``ctvae_torch/utils/images.py::read_png``, zlib
and struct only) against PIL's ``Image.open(f).convert("RGB")``, and
OxfordPets with PNG files against the JAX package's loader (PIL).

Files come from PIL's writer and from an encoder here that writes what
PIL does not: every colour type at every bit depth the PNG specification
allows, the five filters in turn row by row, Adam7 interlace, a palette
shorter than its indices, tRNS, IDAT split over chunks. ``read_png``
must equal PIL exactly; a broken CRC or zlib stream raises naming the
file. OxfordPets' images (decoded, then transformed) are held to JAX's
as ``tests/test_torch_celeba.py`` holds them: 2/255 for JPEG files (the
port's libjpeg build against PIL's), 1/255 for PNG files (the same
pixels; JAX's one-image transform resizes uint8 levels, truncated from
the float image, where the port resizes the float image).
"""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ctvae_torch.utils.images import png_bytes, png_rgb, read_png

DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
JPEG_ATOL = 2.0 / 255.0 + 1e-6
PNG_ATOL = 1.0 / 255.0 + 1e-6


def _chunk(tag, body):
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _pack(samples, depth):
    """Samples [h, w, c] -> packed scanline bytes [h, stride]."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint16)
    if depth == 16:
        return np.stack([flat >> 8, flat & 0xFF], -1).reshape(h, -1).astype(
            np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(
        np.uint8).reshape(h, -1)
    return np.packbits(bits, axis=1)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(line, prior, kind, bpp):
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
        out[i] = (x - pred) & 0xFF
    return bytes([kind]) + bytes(out)


def _encode(samples, color, depth, interlace=0, palette=None, trns=None):
    """A PNG of ``samples`` [h, w, channels] (raw sample values), each
    pass's rows filtered None, Sub, Up, Average, Paeth in turn."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    raw = bytearray()
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        rows = _pack(sub, depth)
        prior = bytes(rows.shape[1])
        for y, row in enumerate(rows):
            line = row.tobytes()
            raw += _filtered(line, prior, (y + x0) % 5, bpp)
            prior = line
    data = zlib.compress(bytes(raw), 9)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    half = len(data) // 2
    return (out + _chunk(b"IDAT", data[:half]) + _chunk(b"IDAT", data[half:])
            + _chunk(b"IEND", b""))


def _pil(data, tmp_path, name="x.png"):
    path = tmp_path / name
    path.write_bytes(data)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


CASES = [(color, depth) for color in sorted(DEPTHS) for depth in DEPTHS[color]]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color,depth", CASES)
def test_read_png_matches_pil(tmp_path, color, depth, interlace):
    """Each colour type at each of its bit depths, plain and Adam7, on an
    11 x 13 image (Adam7's passes partial), every filter in use: the
    file PIL reads, read by ``read_png`` to the same uint8 RGB. A palette
    of fewer entries than the indices used (PIL: black), tRNS on grey,
    RGB and palette images (dropped by ``convert("RGB")``)."""
    rng = np.random.default_rng(color * 100 + depth * 2 + interlace)
    h, w, c = 11, 13, CHANNELS[color]
    top = (1 << depth) - 1
    if color == 0 and depth == 16:
        top = 600                   # PIL's 16-bit grey converts by value
    samples = rng.integers(0, top + 1, (h, w, c))
    palette = trns = None
    if color == 3:
        palette = rng.integers(0, 256, (max(1, (top + 1) * 3 // 4), 3))
        trns = bytes(rng.integers(0, 256, 2).astype(np.uint8))
    elif color in (0, 2):
        trns = struct.pack(">" + "H" * c, *samples[0, 0])
    data = _encode(samples, color, depth, interlace, palette, trns)
    want = _pil(data, tmp_path)
    got = png_rgb(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "RGB", "RGBA", "P", "P4",
                                  "I;16"])
def test_read_png_reads_what_pil_writes(tmp_path, mode):
    """Files PIL writes (its own filter choice, ``optimize``), 16-bit grey
    included: ``read_png`` equals PIL's ``convert("RGB")`` of them."""
    rng = np.random.default_rng(len(mode))
    shape = (29, 31)
    if mode == "1":
        im = Image.fromarray(rng.integers(0, 2, shape).astype(bool))
    elif mode == "I;16":
        im = Image.fromarray(rng.integers(0, 1000, shape).astype(np.uint16))
    elif mode.startswith("P"):
        im = Image.fromarray(rng.integers(0, 256, shape + (3,)).astype(
            np.uint8)).quantize(16 if mode == "P4" else 256)
    else:
        c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        im = Image.fromarray(rng.integers(0, 256, shape + (c,)).astype(
            np.uint8).squeeze(), mode)
    for optimize in (False, True):
        path = tmp_path / f"pil_{optimize}.png"
        im.save(path, optimize=optimize,
                **({"bits": 4} if mode == "P4" else {}))
        with Image.open(path) as back:
            want = np.asarray(back.convert("RGB"))
        np.testing.assert_array_equal(read_png(str(path)), want)


def test_png_writer_round_trips(tmp_path):
    """``png_bytes`` (the grids' writer) read back by ``read_png`` and by
    PIL: grey as three equal channels, RGB as written, RGBA without its
    alpha."""
    rng = np.random.default_rng(7)
    for shape in ((9, 14), (9, 14, 3), (9, 14, 4)):
        arr = rng.integers(0, 256, shape).astype(np.uint8)
        data = png_bytes(arr)
        want = (np.repeat(arr[..., None], 3, 2) if arr.ndim == 2
                else arr[..., :3])
        np.testing.assert_array_equal(png_rgb(data), want)
        np.testing.assert_array_equal(_pil(data, tmp_path), want)


def test_read_png_raises_naming_the_file(tmp_path):
    """A flipped byte of IDAT (its CRC no longer matches), a stream that
    is not zlib (the CRC made to match), a file cut short and bytes that
    are no PNG each raise ValueError naming the file."""
    data = bytearray(png_bytes(np.arange(48, dtype=np.uint8).reshape(4, 12)))
    at = data.index(b"IDAT")
    cases = {"crc": bytearray(data), "zlib": bytearray(data),
             "short": data[:at + 12], "none": b"GIF89a" + bytes(data[6:])}
    cases["crc"][at + 6] ^= 0xFF
    length = struct.unpack(">I", data[at - 4:at])[0]
    body = bytes(8) * (length // 8) + bytes(length % 8)
    cases["zlib"][at + 4:at + 4 + length] = body
    cases["zlib"][at + 4 + length:at + 8 + length] = struct.pack(
        ">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF)
    match = {"crc": "broken CRC", "zlib": "zlib", "short": "truncated",
             "none": "no PNG signature"}
    for name, bad in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=match[name]) as e:
            read_png(str(path))
        assert str(path) in str(e.value)


def _oxford(root):
    """An OxfordPets folder of JPEG files, PNG files (RGB, grey, palette,
    RGBA 16-bit, interlaced) and PNG bytes named ``.jpg``."""
    folder = os.path.join(root, "OxfordPets", "images")
    os.makedirs(folder)
    rng = np.random.default_rng(11)
    for i, (h, w) in enumerate([(70, 90), (64, 64), (100, 80)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8)).save(os.path.join(folder, f"a_{i}.jpg"), quality=85)
    Image.fromarray(rng.integers(0, 256, (75, 60)).astype(np.uint8),
                    "L").save(os.path.join(folder, "b_grey.jpg"), quality=85)
    Image.fromarray(rng.integers(0, 256, (66, 77, 3)).astype(
        np.uint8)).save(os.path.join(folder, "c_rgb.png"))
    Image.fromarray(rng.integers(0, 256, (50, 70)).astype(np.uint8),
                    "L").save(os.path.join(folder, "d_grey.png"))
    with open(os.path.join(folder, "e_rgba16.png"), "wb") as f:
        f.write(_encode(rng.integers(0, 1 << 16, (40, 45, 4)), 6, 16, 1))
    Image.fromarray(rng.integers(0, 256, (80, 64, 3)).astype(
        np.uint8)).quantize(64).save(os.path.join(folder, "f_named.jpg"),
                                     format="PNG")
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_oxford_pets_reads_png_as_jax(tmp_path, split):
    """OxfordPets over ``.jpg`` and ``.png`` files, one of them PNG bytes
    under ``.jpg`` and one a grey JPEG: the same file list and split as
    JAX's loader, each image as JAX's (PIL) after the transform, the grey
    JPEG's decode equal to PIL's ``convert("RGB")``; bytes that are
    neither format raise naming the file."""
    from ctvae_torch import native
    from ctvae_torch.data.oxford import OxfordPets, read_image
    from ctvae_tpu.data.oxford import OxfordPets as JOxfordPets
    root = _oxford(str(tmp_path))
    t, j = OxfordPets(root, split=split), JOxfordPets(root, split=split)
    assert t.filename == j.filename and len(t) == (6 if split == "train"
                                                   else 2)
    for i, name in enumerate(t.filename):
        path = os.path.join(root, "OxfordPets", "images", name)
        with open(path, "rb") as f:
            png = f.read(4) == b"\x89PNG"
        assert png == (name.endswith(".png") or name == "f_named.jpg")
        (gi, gl), (wi, wl) = t[i], j[i]
        np.testing.assert_allclose(gi, wi, rtol=0,
                                   atol=PNG_ATOL if png else JPEG_ATOL)
        assert gl == wl == 0.0
        if png or name == "b_grey.jpg":
            with Image.open(path) as im:
                np.testing.assert_array_equal(read_image(path),
                                              np.asarray(im.convert("RGB")))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"GIF89a" + bytes(32))
    with pytest.raises(ValueError, match="bad.jpg"):
        read_image(str(bad))
    assert native.codec().name == "libjpeg"


def test_cmyk_jpeg_is_refused_where_pil_reads_it(tmp_path):
    """A CMYK JPEG (PIL's writer, Adobe's inverted form): PIL reads it to
    RGB, the port's codec refuses it naming the file (libjpeg converts no
    CMYK to RGB). The difference is logged in ROADMAP C."""
    from ctvae_torch.data.oxford import read_image
    path = tmp_path / "cmyk.jpg"
    Image.fromarray(np.random.default_rng(3).integers(
        0, 256, (20, 24, 4)).astype(np.uint8), "CMYK").save(path, quality=85)
    with Image.open(path) as im:
        assert im.mode == "CMYK" and np.asarray(im.convert("RGB")).shape \
            == (20, 24, 3)
    with pytest.raises(OSError, match="cmyk.jpg"):
        read_image(str(path))
