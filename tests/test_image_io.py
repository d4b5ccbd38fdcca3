"""Image files and resizing without OpenCV (io/image.py) and the triangle
rasteriser / overlay of the planar prior (pipeline/prior.py)."""

import struct
import sys
import zlib

import numpy as np
import pytest

from acmmp_spherical_tpu.io import image, native
from acmmp_spherical_tpu.io.scene import (
    ScenePaths, load_image_color, load_image_gray,
)


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3)], ids=["gray", "rgb"])
def test_png_round_trip(tmp_path, rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "a.png"
    image.write_png(path, img)
    np.testing.assert_array_equal(image.read_image(path), img)


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """Encode an RGB image with one PNG filter type on every row (the
    forward filters of the PNG spec, section 9)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        x = rows[y]
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(bytes([ftype]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = x

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [1, 2, 3, 4],
                         ids=["sub", "up", "average", "paeth"])
def test_png_filters_decode(tmp_path, rng, ftype):
    img = rng.integers(0, 256, (5, 8, 3), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, ftype))
    np.testing.assert_array_equal(image.read_image(path), img)


def test_pgm_read(tmp_path, rng):
    img = rng.integers(0, 256, (4, 6), dtype=np.uint8)
    path = tmp_path / "a.pgm"
    path.write_bytes(b"P5\n# comment\n6 4\n255\n" + img.tobytes())
    np.testing.assert_array_equal(image.read_image(path), img)


def test_gray_and_color_loaders(tmp_path, rng):
    rgb = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    image.write_png(tmp_path / "c.png", rgb)
    gray = load_image_gray(tmp_path / "c.png")
    ref = np.round(rgb.astype(np.float32) @ np.float32([0.299, 0.587, 0.114]))
    np.testing.assert_array_equal(gray, ref)
    np.testing.assert_array_equal(load_image_color(tmp_path / "c.png"), rgb)
    with pytest.raises(FileNotFoundError):
        load_image_gray(tmp_path / "missing.png")


def test_jpeg_without_pillow_names_the_package(tmp_path, monkeypatch):
    path = tmp_path / "a.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 16)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        image.read_image(path)


def test_scene_image_file_finds_png(tmp_path):
    sp = ScenePaths(tmp_path)
    sp.images_dir.mkdir()
    assert sp.image_file(0).name == "00000000.jpg"
    image.write_png(sp.images_dir / "00000000.png", np.zeros((2, 2), np.uint8))
    assert sp.image_file(0).name == "00000000.png"


@pytest.mark.parametrize("dst", [(20, 31), (9, 14), (40, 50)])
def test_resize_numpy_matches_native(rng, dst):
    src = rng.uniform(0, 255, (23, 37)).astype(np.float32)
    want = image.resize_bilinear_np(src, *dst)
    assert want.shape == dst
    if not native.available():
        pytest.skip("native library not built")
    np.testing.assert_allclose(native.resize_bilinear(src, *dst), want,
                               rtol=0, atol=1e-4)


def test_resize_halves_by_averaging(rng):
    src = rng.uniform(0, 255, (8, 12)).astype(np.float32)
    half = image.resize_bilinear_np(src, 4, 6)
    ref = src.reshape(4, 2, 6, 2).mean(axis=(1, 3))
    np.testing.assert_allclose(half, ref, rtol=1e-5, atol=1e-3)
    rgb = np.stack([src] * 3, axis=-1)
    np.testing.assert_allclose(image.resize_bilinear(rgb, 4, 6)[..., 1],
                               half, atol=1e-3)


def test_rasterize_numpy_matches_native(monkeypatch):
    from acmmp_spherical_tpu.pipeline import prior

    tris = np.array([[[1, 1], [15, 2], [6, 12]],
                     [[15, 2], [18, 14], [6, 12]],
                     [[0, 0], [0, 0], [3, 3]]], np.int32)   # degenerate
    got = prior.rasterize_triangles(tris, 16, 20)
    assert set(np.unique(got)) == {0, 1, 2}
    assert got[1, 1] == 1 and got[12, 6] in (1, 2)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(prior.rasterize_triangles(tris, 16, 20), got)


def test_draw_triangulation_marks_edges():
    from acmmp_spherical_tpu.pipeline.prior import draw_triangulation

    img = np.full((10, 12), 100.0, np.float32)
    tri = np.array([[[0, 0], [9, 0], [0, 9]]])
    out = draw_triangulation(img, tri)
    assert out.shape == (10, 12, 3) and out.dtype == np.uint8
    red = (out == (255, 0, 0)).all(axis=-1)
    assert red[0, :10].all() and red[:10, 0].all() and red[4, 5]
    assert not red[9, 11] and (out[9, 11] == 100).all()
