"""ctypes bindings for the native C++ runtime library.

Builds ``native/libacmmp_native.so`` from ``native/acmmp_native.cpp`` at first
use (the library is never committed; ``make -C native`` builds the same file)
and exposes typed wrappers.  Every caller has a pure-numpy fallback, so the
framework works without a C++ compiler; when the library is present the IO and
prior modules use it (the same split as the reference, whose entire host
runtime is C++).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_SOURCE = _NATIVE_DIR / "acmmp_native.cpp"
_LIB_PATH = _NATIVE_DIR / "libacmmp_native.so"
# the flags of native/Makefile; no -march=native, so the build gives the same
# float results on every x86-64 host
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]
_lib = None
_tried = False


def build(target: Path = _LIB_PATH) -> None:
    """Compile the library from source into ``target``.  The result is
    renamed into place, so concurrent builds (test workers) never load a
    half-written file.  Raises on failure."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise FileNotFoundError("no C++ compiler (g++/c++) on PATH")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=Path(target).parent)
    os.close(fd)
    try:
        subprocess.run([cxx, *_CXXFLAGS, "-o", tmp, str(_SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build() -> bool:
    try:
        build()
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def load() -> ctypes.CDLL | None:
    """Load (building if necessary) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("ACMMP_NO_NATIVE") == "1":
        return None
    if not _LIB_PATH.exists() and not _build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    c_char_p = ctypes.c_char_p
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    i32ptr = ctypes.POINTER(ctypes.c_int32)
    lib.dmb_read_header.argtypes = [c_char_p, i32ptr, i32ptr, i32ptr]
    lib.dmb_read_header.restype = ctypes.c_int
    lib.dmb_read_data.argtypes = [c_char_p, f32p, ctypes.c_int64]
    lib.dmb_read_data.restype = ctypes.c_int
    lib.dmb_write.argtypes = [c_char_p, f32p, ctypes.c_int32, ctypes.c_int32,
                              ctypes.c_int32]
    lib.dmb_write.restype = ctypes.c_int
    lib.ply_write.argtypes = [c_char_p, f32p, f32p, u8p, ctypes.c_int64]
    lib.ply_write.restype = ctypes.c_int
    lib.support_points.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_float, i32p]
    lib.support_points.restype = ctypes.c_int64
    lib.rasterize_triangles.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                        ctypes.c_int32, i32p]
    lib.rasterize_triangles.restype = None
    lib.resize_bilinear_f32.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32,
                                        f32p, ctypes.c_int32, ctypes.c_int32]
    lib.resize_bilinear_f32.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


# ---------------------------------------------------------------------------
# typed wrappers (with availability checks left to callers)
# ---------------------------------------------------------------------------

def dmb_write(path, array: np.ndarray) -> None:
    lib = load()
    a = np.ascontiguousarray(array, np.float32)
    h, w = a.shape[:2]
    nb = 1 if a.ndim == 2 else a.shape[2]
    rc = lib.dmb_write(str(path).encode(), a.reshape(-1), h, w, nb)
    if rc != 0:
        raise IOError(f"dmb_write({path}) failed rc={rc}")


def dmb_read(path) -> np.ndarray:
    lib = load()
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    nb = ctypes.c_int32()
    rc = lib.dmb_read_header(str(path).encode(), ctypes.byref(h),
                             ctypes.byref(w), ctypes.byref(nb))
    if rc != 0:
        raise IOError(f"dmb_read_header({path}) failed rc={rc}")
    out = np.empty(h.value * w.value * nb.value, np.float32)
    rc = lib.dmb_read_data(str(path).encode(), out, out.size)
    if rc != 0:
        raise IOError(f"dmb_read_data({path}) failed rc={rc}")
    shape = (h.value, w.value) if nb.value == 1 else (h.value, w.value, nb.value)
    return out.reshape(shape)


def ply_write(path, points, normals, colors) -> None:
    lib = load()
    p = np.ascontiguousarray(points, np.float32)
    n = np.ascontiguousarray(normals, np.float32)
    c = np.ascontiguousarray(np.clip(colors, 0, 255), np.uint8)
    rc = lib.ply_write(str(path).encode(), p.reshape(-1), n.reshape(-1),
                       c.reshape(-1), len(p))
    if rc != 0:
        raise IOError(f"ply_write({path}) failed rc={rc}")


def support_points(cost: np.ndarray, cell: int, threshold: float) -> np.ndarray:
    lib = load()
    c = np.ascontiguousarray(cost, np.float32)
    h, w = c.shape
    cap = ((h + cell - 1) // cell) * ((w + cell - 1) // cell)
    out = np.empty(2 * cap, np.int32)
    n = lib.support_points(c.reshape(-1), h, w, cell, threshold, out)
    return out[: 2 * n].reshape(-1, 2).copy()


def rasterize_triangles(tris: np.ndarray, h: int, w: int) -> np.ndarray:
    lib = load()
    t = np.ascontiguousarray(tris.reshape(-1, 6), np.int32)
    mask = np.zeros(h * w, np.int32)
    lib.rasterize_triangles(t.reshape(-1), len(t), h, w, mask)
    return mask.reshape(h, w)


def resize_bilinear(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    lib = load()
    s = np.ascontiguousarray(src, np.float32)
    out = np.empty(dh * dw, np.float32)
    lib.resize_bilinear_f32(s.reshape(-1), s.shape[0], s.shape[1], out, dh, dw)
    return out.reshape(dh, dw)
