"""FAST detector tests: golden Bresenham geometry (vs the reference's
midpoint circle construction), contiguity semantics on synthetic patterns, end-to-end detection
on a rendered scene. Mirrors the useful parts of the reference's
FastDetectorTest.cc (golden circle check :6-31, synthetic contiguity
:38-80) with real asserts."""

import jax.numpy as jnp
import numpy as np
import pytest

from ya_vo_tpu.features import fast
from ya_vo_tpu.utils import synthetic


def _midpoint_circle(r: int):
    """The radius-r circle by the midpoint construction the reference uses
    (src/FastDetector.cc:50-112): step one octant, mirror it eight ways."""
    pts = set()
    x, y, p = r, 0, 1 - r
    while x >= y:
        for a, b in ((x, y), (y, x)):
            pts |= {(sa * a, sb * b) for sa in (1, -1) for sb in (1, -1)}
        y += 1
        if p <= 0:
            p += 2 * y + 1
        else:
            x -= 1
            p += 2 * y - 2 * x + 1
    return pts


def test_bresenham_offsets_match_reference_golden():
    """The 16 ring offsets are the reference's radius-3 circle, ordered
    clockwise from 12 o'clock with each step to an 8-neighbour (the
    contiguity test walks the ring in this order)."""
    ours = [(int(dv), int(du)) for dv, du in fast.BRESENHAM_OFFSETS]
    assert len(set(ours)) == 16
    assert set(ours) == _midpoint_circle(3)
    assert ours[0] == (-3, 0)
    ang = np.unwrap([np.arctan2(du, -dv) for dv, du in ours])
    assert np.all(np.diff(ang) > 0)
    for (a, b), (c, d) in zip(ours, ours[1:] + ours[:1]):
        assert max(abs(a - c), abs(b - d)) == 1


def _ring_image(on_indices, center_val=100, ring_val=200, size=50):
    img = np.full((size, size), center_val, dtype=np.uint8)
    c = size // 2
    for k in on_indices:
        dv, du = fast.BRESENHAM_OFFSETS[k]
        img[c + dv, c + du] = ring_val
    return img


def test_contiguous_12_detected():
    img = _ring_image(range(12))
    corner = fast.fast_response(jnp.asarray(img, jnp.float32), 40.0, 12)
    assert bool(corner[25, 25])


def test_contiguous_11_rejected():
    img = _ring_image(range(11))
    corner = fast.fast_response(jnp.asarray(img, jnp.float32), 40.0, 12)
    assert not bool(corner[25, 25])


def test_wraparound_arc_detected():
    # arc spanning the ring seam: indices 10..15 + 0..5 (12 contiguous)
    img = _ring_image(list(range(10, 16)) + list(range(6)))
    corner = fast.fast_response(jnp.asarray(img, jnp.float32), 40.0, 12)
    assert bool(corner[25, 25])


def test_darker_arc_detected():
    img = _ring_image([], center_val=200)
    c = 25
    for k in range(12):
        dv, du = fast.BRESENHAM_OFFSETS[k]
        img[c + dv, c + du] = 40
    corner = fast.fast_response(jnp.asarray(img, jnp.float32), 40.0, 12)
    assert bool(corner[25, 25])


def test_flat_image_no_corners():
    img = jnp.full((64, 64), 128, jnp.uint8)
    kps = fast.detect(img, max_keypoints=128, border=8)
    assert int(kps.count()) == 0


def test_small_blob_detected_at_center():
    """A bright 3x3 blob fits inside the radius-3 ring: all 16 ring pixels
    are darker -> strongest possible FAST response at the blob center."""
    img = np.full((96, 96), 20, dtype=np.uint8)
    img[47:50, 47:50] = 220
    kps = fast.detect(jnp.asarray(img), max_keypoints=64, border=8)
    n = int(kps.count())
    assert n >= 1
    uv = np.asarray(kps.uv)[np.asarray(kps.mask)]
    d = np.min(np.linalg.norm(uv - np.array([48.0, 48.0]), axis=-1))
    assert d <= 2.0, uv


def test_axis_aligned_square_corner_not_fast12():
    """Regression-documenting test: a perfect 90-degree axis-aligned corner
    yields only 11 contiguous ring pixels, below FAST-12's threshold —
    detection must rely on texture, not smooth right angles."""
    img = np.full((96, 96), 20, dtype=np.uint8)
    img[40:61, 40:61] = 220
    corner = fast.fast_response(jnp.asarray(img, jnp.float32), 40.0, 12)
    assert not bool(corner[40, 40])
    # ... but FAST-9 does fire there
    corner9 = fast.fast_response(jnp.asarray(img, jnp.float32), 40.0, 9)
    assert bool(corner9[40, 40])


def test_rendered_scene_detection():
    imgs, poses, lms, cam = synthetic.render_sequence(
        n_frames=1, n_landmarks=120, height=256, width=512, seed=1
    )
    kps = fast.detect(jnp.asarray(imgs[0]), max_keypoints=1024, border=16)
    assert int(kps.count()) > 100
    # all reported keypoints respect the border and the mask is prefix-sorted
    uv = np.asarray(kps.uv)[np.asarray(kps.mask)]
    assert uv[:, 0].min() >= 16 and uv[:, 0].max() < 512 - 16
    assert uv[:, 1].min() >= 16 and uv[:, 1].max() < 256 - 16
    # scores are sorted descending among valid entries
    sc = np.asarray(kps.score)[np.asarray(kps.mask)]
    assert np.all(np.diff(sc) <= 1e-3)


@pytest.mark.parametrize("threshold,arc", [(20.0, 12), (40.0, 9)])
def test_fast_response_matches_brute_force(threshold, arc):
    """fast_response == a per-pixel numpy segment test (the reference's
    checkContiguousPixels, src/FastDetector.cc:135-153) on a rendered
    frame, away from the 3-pixel border the ring wraps across."""
    imgs, *_ = synthetic.render_sequence(
        n_frames=1, n_landmarks=80, height=128, width=256, seed=4)
    img = imgs[0].astype(np.float32)
    got = np.asarray(fast.fast_response(jnp.asarray(img), threshold, arc))
    want = np.zeros_like(got)
    for v in range(3, 125):
        for u in range(3, 253):
            c = img[v, u]
            ring = np.array([img[v + dv, u + du]
                             for dv, du in fast.BRESENHAM_OFFSETS])
            for side in (ring > c + threshold, ring < c - threshold):
                if any(all(side[(k + i) % 16] for i in range(arc))
                       for k in range(16)):
                    want[v, u] = True
    assert want.sum() > 20
    np.testing.assert_array_equal(got[3:-3, 3:-3], want[3:-3, 3:-3])
