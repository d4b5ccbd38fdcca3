"""Image files and resampling with numpy and the standard library.

PNG (8/16-bit grey, grey+alpha, RGB, RGBA, palette; non-interlaced) and
binary PGM/PPM are read and PNG is written with ``zlib`` alone.  JPEG is
decoded through Pillow, imported only when a JPEG is met.  The format is
taken from the file's first bytes, not its name.

``resize_bilinear`` is the pixel-centre-aligned bilinear resize the reference
gets from ``cv::resize(..., INTER_LINEAR)`` (ACMMP.cpp:605-643); it runs in
the native library when that is built and in numpy otherwise.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_image(path) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 array of an image file (16-bit PNG samples
    keep their high byte)."""
    data = Path(path).read_bytes()
    if data.startswith(_PNG_MAGIC):
        return _decode_png(data, path)
    if data[:2] in (b"P5", b"P6"):
        return _decode_pnm(data, path)
    if data.startswith(b"\xff\xd8"):
        return _decode_jpeg(path)
    raise ValueError(f"{path}: not a PNG, PGM/PPM or JPEG file")


def to_gray(img: np.ndarray) -> np.ndarray:
    """float32 luma in 0..255 (ITU-R BT.601 weights, as cv::imread
    IMREAD_GRAYSCALE)."""
    if img.ndim == 2:
        return img.astype(np.float32)
    rgb = img[..., :3].astype(np.float32)
    if img.shape[-1] < 3:
        return rgb[..., 0]
    return np.round(rgb @ np.float32([0.299, 0.587, 0.114])).astype(np.float32)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] < 3:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def write_png(path, img: np.ndarray) -> None:
    """Write a (H, W) grey or (H, W, 3) RGB uint8 array as a PNG."""
    img = np.ascontiguousarray(np.clip(img, 0, 255).astype(np.uint8))
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"write_png: unsupported shape {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    Path(path).write_bytes(
        _PNG_MAGIC + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b""))


def _decode_png(data: bytes, path) -> np.ndarray:
    pos = len(_PNG_MAGIC)
    idat = []
    palette = None
    header = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = header
    if interlace or depth not in (8, 16) or color_type not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour "
                         f"type {color_type}, interlace {interlace})")
    ch = _CHANNELS[color_type]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:]
        out[y] = prev = _unfilter(ftype, line, prev, bpp, path)
    img = out.reshape(h, w, bpp)
    if depth == 16:
        img = img[..., 0::2]          # high byte of each big-endian sample
    if color_type == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[img[..., 0]]
    return img[..., 0] if ch == 1 else img


def _unfilter(ftype, line, prev, bpp, path) -> np.ndarray:
    """Undo one scanline's PNG filter (PNG spec section 9)."""
    if ftype == 0:
        return line
    if ftype == 2:
        return line + prev
    if ftype == 1:
        px = line.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    if ftype not in (3, 4):
        raise ValueError(f"{path}: bad PNG filter type {ftype}")
    cur = np.zeros(len(line), np.int64)
    up = prev.astype(np.int64)
    f = line.astype(np.int64)
    for i in range(0, len(line), bpp):
        sl = slice(i, i + bpp)
        left = cur[i - bpp:i] if i else np.zeros(bpp, np.int64)
        if ftype == 3:
            pred = (left + up[sl]) >> 1
        else:
            ul = up[i - bpp:i] if i else np.zeros(bpp, np.int64)
            p = left + up[sl] - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up[sl]), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up[sl], ul))
        cur[sl] = (f[sl] + pred) & 0xFF
    return cur.astype(np.uint8)


def _decode_pnm(data: bytes, path) -> np.ndarray:
    fields = []
    pos = 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    pos += 1                               # the single whitespace byte
    w, h, maxval = fields
    ch = 1 if data[:2] == b"P5" else 3
    dtype = np.dtype(">u2") if maxval > 255 else np.uint8
    img = np.frombuffer(data, dtype, count=w * h * ch, offset=pos)
    if maxval > 255:
        img = (img.astype(np.uint32) * 255 // maxval).astype(np.uint8)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, 3)


def _decode_jpeg(path) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: decoding JPEG needs the Pillow package "
            "(pip install pillow); PNG and PGM images need nothing "
            "beyond numpy") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("L" if im.mode in ("L", "I", "F")
                                     else "RGB"))


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Pixel-centre-aligned bilinear resize of a (H, W) or (H, W, C) image to
    (height, width), float32 (cv::INTER_LINEAR sampling)."""
    from acmmp_spherical_tpu.io import native

    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        return np.stack([resize_bilinear(img[..., c], height, width)
                         for c in range(img.shape[2])], axis=-1)
    if native.available():
        return native.resize_bilinear(img, height, width)
    return resize_bilinear_np(img, height, width)


def resize_bilinear_np(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """numpy twin of the native ``resize_bilinear_f32``, same float32
    arithmetic."""
    sh, sw = img.shape

    def axis(n_out, n_in):
        f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
             * (np.float32(n_in) / np.float32(n_out)) - np.float32(0.5))
        i0 = np.floor(f).astype(np.int64)
        wgt = (f - i0).astype(np.float32)
        return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), wgt)

    x0, x1, wx = axis(width, sw)
    y0, y1, wy = axis(height, sh)
    r0, r1 = img[y0], img[y1]
    top = r0[:, x0] + (r0[:, x1] - r0[:, x0]) * wx
    bot = r1[:, x0] + (r1[:, x1] - r1[:, x0]) * wx
    return (top + (bot - top) * wy[:, None]).astype(np.float32)
