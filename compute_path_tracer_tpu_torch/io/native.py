"""ctypes bindings of the native host library (JAX package: ``io/native.py``).

``native/cpt_native.cpp`` at the repository root holds the host-side fast
paths of the image export (HDR to gamma-encoded RGBA8, PNG encoding with
zlib) and the wang_hash chain as an independent cross-check of
``ops/rng.py``.  At first use it is compiled by ``g++`` into
``build/native/<hash of the source and flags>/libcpt_native.so`` under the
repository root, through a temporary file and a rename so that concurrent
first uses do not clash (``native/`` itself is left alone).  Everything
degrades gracefully: ``available()`` is False when the source, the
compiler or zlib is missing, and ``io/png.py`` then takes its pure-Python
codec, which gives the same pixels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "cpt_native.cpp"
BUILD_DIR = ROOT / "build" / "native"
LIB_NAME = "libcpt_native.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library of the current source lands."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def _build() -> Optional[Path]:
    if not SOURCE.exists():
        return None
    out = library_path()
    if out.exists():
        return out
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            lib = os.path.join(tmp, LIB_NAME)
            subprocess.run(["g++", *GXX_FLAGS, "-o", lib, str(SOURCE), "-lz"],
                           check=True, capture_output=True, timeout=120)
            os.replace(lib, out)
    except (OSError, subprocess.SubprocessError):
        return None
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32 = ctypes.c_int32
        lib.cpt_hdr_to_rgba8.argtypes = [f32p, i32, i32, ctypes.c_float, i32,
                                         u8p]
        lib.cpt_hdr_to_rgba8.restype = None
        lib.cpt_encode_png_rgba.restype = ctypes.c_void_p
        lib.cpt_encode_png_rgba.argtypes = [u8p, i32, i32, i32,
                                            ctypes.POINTER(ctypes.c_size_t)]
        lib.cpt_free.argtypes = [ctypes.c_void_p]
        lib.cpt_free.restype = None
        lib.cpt_wang_hash.argtypes = [u32p, u32p, ctypes.c_size_t]
        lib.cpt_wang_hash.restype = None
        _lib = lib
        return _lib


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def available() -> bool:
    """Whether the library is built (or could be built now) and loads."""
    return _load() is not None


def hdr_to_rgba8_native(img: np.ndarray, gamma: float = 2.2,
                        flip_y: bool = True) -> np.ndarray:
    """``io/png.py:hdr_to_rgba8`` in C++: (H, W, 3) float32 to (H, W, 4)
    uint8, the same bytes."""
    lib = _need()
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    lib.cpt_hdr_to_rgba8(img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         h, w, ctypes.c_float(gamma), 1 if flip_y else 0,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def encode_png_rgba_native(rgba: np.ndarray, compress_level: int = 6) -> bytes:
    """An (H, W, 4) uint8 image as a PNG byte string, encoded in C++."""
    lib = _need()
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    out_len = ctypes.c_size_t(0)
    ptr = lib.cpt_encode_png_rgba(
        rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        compress_level, ctypes.byref(out_len))
    if not ptr:
        raise RuntimeError("native png encode failed")
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.cpt_free(ptr)


def wang_hash_native(seeds: np.ndarray) -> np.ndarray:
    """One wang_hash step of each uint32 seed, in C++ (``ops/rng.py``'s
    cross-check)."""
    lib = _need()
    seeds = np.ascontiguousarray(seeds, np.uint32)
    out = np.empty_like(seeds)
    lib.cpt_wang_hash(seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                      seeds.size)
    return out
