"""Native C PNG decoder: exactness vs PIL on gray, luma on RGB, error paths.
The library is built with `make -C native` when it is missing; the tests
skip only when it cannot be built (no C compiler or zlib)."""

import os
import subprocess

import numpy as np
import pytest

from ya_vo_tpu.io import native_loader

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


@pytest.fixture(scope="module", autouse=True)
def native_lib():
    if not native_loader.available():
        try:
            subprocess.run(["make", "-C", _NATIVE], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            pytest.skip(f"native library cannot be built: {e}")
        native_loader._TRIED = False
    assert native_loader.available()


def _save(tmp_path, arr, mode, name):
    from PIL import Image

    p = str(tmp_path / name)
    Image.fromarray(arr, mode).save(p)
    return p


def test_gray_exact(tmp_path, rng):
    g = rng.integers(0, 255, (123, 251), dtype=np.uint8)
    d = native_loader.decode_png_gray(_save(tmp_path, g, "L", "g.png"))
    np.testing.assert_array_equal(d, g)


def test_rgb_luma(tmp_path, rng):
    c = rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
    d = native_loader.decode_png_gray(_save(tmp_path, c, "RGB", "c.png"))
    ci = c.astype(np.int64)
    luma = ((77 * ci[..., 0] + 150 * ci[..., 1] + 29 * ci[..., 2]) >> 8)
    np.testing.assert_array_equal(d, luma.astype(np.uint8))


def test_rgba(tmp_path, rng):
    c = rng.integers(0, 255, (30, 40, 4), dtype=np.uint8)
    d = native_loader.decode_png_gray(_save(tmp_path, c, "RGBA", "a.png"))
    ci = c.astype(np.int64)
    luma = ((77 * ci[..., 0] + 150 * ci[..., 1] + 29 * ci[..., 2]) >> 8)
    np.testing.assert_array_equal(d, luma.astype(np.uint8))


def test_kitti_shaped_frame(tmp_path, rng):
    g = rng.integers(0, 255, (376, 1241), dtype=np.uint8)
    d = native_loader.decode_png_gray(_save(tmp_path, g, "L", "k.png"))
    np.testing.assert_array_equal(d, g)


def test_corrupt_files(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    assert native_loader.decode_png_gray(str(bad)) is None
    trunc = tmp_path / "trunc.png"
    trunc.write_bytes(bytes([137, 80, 78, 71, 13, 10, 26, 10, 0, 0]))
    assert native_loader.decode_png_gray(str(trunc)) is None


def test_loader_integration(tmp_path, rng):
    """load_image_gray prefers the native decoder and matches PIL."""
    from ya_vo_tpu.io.kitti import load_image_gray

    g = rng.integers(0, 255, (100, 200), dtype=np.uint8)
    p = _save(tmp_path, g, "L", "f.png")
    np.testing.assert_array_equal(load_image_gray(p), g)
