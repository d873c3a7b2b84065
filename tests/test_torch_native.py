"""Port parity: the native host library's bindings (io/native.py) against the
port's plain versions, as tests/test_native.py holds the JAX package's:
the C++ export (HDR to RGBA8, PNG encoding) against io/png.py and its
wang_hash against ops/rng.py's torch chain, bit for bit.  The library is
built with g++ at first use into build/native/; the tests skip (inside the
test, so that every worker collects the same tests) where it cannot be
built."""

import numpy as np
import pytest
import torch

from compute_path_tracer_tpu_torch.io import native
from compute_path_tracer_tpu_torch.io.png import (
    encode_png_rgba,
    hdr_to_rgba8,
    load_png_rgba,
    save_png,
)
from compute_path_tracer_tpu_torch.ops.rng import wang_hash


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("the native library cannot be built here (g++ or zlib)")
    assert native.library_path().exists()
    assert native.library_path().parent.parent == native.BUILD_DIR


def test_hdr_to_rgba8_matches_python(lib):
    rng = np.random.default_rng(1)
    img = (rng.random((33, 47, 3)) * 1.5 - 0.2).astype(np.float32)
    for flip in (True, False):
        a = native.hdr_to_rgba8_native(img, gamma=2.2, flip_y=flip)
        b = hdr_to_rgba8(img, gamma=2.2, flip_y=flip)
        np.testing.assert_array_equal(a, b)


def test_native_png_roundtrip(lib, tmp_path):
    rng = np.random.default_rng(2)
    rgba = (rng.random((20, 31, 4)) * 255).astype(np.uint8)
    data = native.encode_png_rgba_native(rgba)
    p = tmp_path / "n.png"
    p.write_bytes(data)
    np.testing.assert_array_equal(load_png_rgba(str(p)), rgba)
    # The same image as the plain encoder's, read back.
    q = tmp_path / "p.png"
    q.write_bytes(encode_png_rgba(rgba))
    np.testing.assert_array_equal(load_png_rgba(str(q)), rgba)


def test_native_wang_hash_matches_torch(lib):
    seeds = (np.arange(1, 4097, dtype=np.uint64) * np.uint64(2654435761)
             ).astype(np.uint32)
    a = native.wang_hash_native(seeds)
    b = wang_hash(torch.from_numpy(seeds.astype(np.int64))).numpy()
    np.testing.assert_array_equal(a.astype(np.int64), b)


def test_save_png_uses_native(lib, tmp_path, monkeypatch):
    img = np.random.default_rng(3).random((8, 8, 3)).astype(np.float32)
    calls = []
    encode = native.encode_png_rgba_native
    monkeypatch.setattr(native, "encode_png_rgba_native",
                        lambda *a, **k: calls.append(1) or encode(*a, **k))
    p = str(tmp_path / "s.png")
    save_png(p, img)
    assert calls, "save_png did not take the native encoder"
    np.testing.assert_array_equal(load_png_rgba(p), hdr_to_rgba8(img))
