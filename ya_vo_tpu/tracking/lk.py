"""Batched pyramidal Lucas-Kanade optical flow.

Replaces the reference's cv::calcOpticalFlowPyrLK call (reference:
src/LoopHandler.cc:372-375 — 11x11 window, 3 pyramid levels, 30 iterations,
eps 0.01, seeded with map-point projections) with a fully vectorized
inverse-compositional KLT: every keypoint's window is gathered with bilinear
interpolation, the 2x2 normal matrix and update are batched over all
keypoints, and the per-level iteration is a `lax.fori_loop`. One jit for the
whole pyramid. Status is decided like OpenCV's: in-bounds + well-conditioned
G + converged residual.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class FlowResult(NamedTuple):
    uv: jnp.ndarray       # [N, 2] tracked positions in the new image
    status: jnp.ndarray   # [N] bool track success
    residual: jnp.ndarray # [N] mean abs photometric residual at solution


def _decimation_matrix(n: int) -> jnp.ndarray:
    """[n//2, n] banded 2-tap averaging matrix (rows sum to 1)."""
    n2 = n // 2
    A = np.zeros((n2, n), np.float32)
    idx = np.arange(n2)
    A[idx, 2 * idx] = 0.5
    A[idx, 2 * idx + 1] = 0.5
    return jnp.asarray(A)


def build_pyramid(img_f32: jnp.ndarray, levels: int) -> Tuple[jnp.ndarray, ...]:
    """Image pyramid: level 0 = full res, each next level 2x-downsampled
    with a 2x2 average (shapes stay static per level).

    The 2x2 average is two banded matmuls (A_r @ img @ A_c^T) rather than a
    strided reshape-mean. HIGHEST precision keeps the average exact in
    f32 (no TF32 rounding of the intensities)."""
    pyr = [img_f32]
    cur = img_f32
    for _ in range(levels - 1):
        H, W = cur.shape
        Ar = _decimation_matrix(H)
        Ac = _decimation_matrix(W)
        rows = jax.lax.dot_general(
            Ar, cur, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)        # [H//2, W]
        cur = jax.lax.dot_general(
            rows, Ac, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)        # [H//2, W//2]
        pyr.append(cur)
    return tuple(pyr)


def _bilinear(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample img[v, u] for float coords of any shape."""
    H, W = img.shape
    u = jnp.clip(u, 0.0, W - 1.001)
    v = jnp.clip(v, 0.0, H - 1.001)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    du = u - u0
    dv = v - v0
    i00 = img[v0, u0]
    i01 = img[v0, u0 + 1]
    i10 = img[v0 + 1, u0]
    i11 = img[v0 + 1, u0 + 1]
    return (
        i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
        + i10 * (1 - du) * dv + i11 * du * dv
    )


def _track_level(
    img0: jnp.ndarray, img1: jnp.ndarray,
    uv0: jnp.ndarray, uv1: jnp.ndarray,
    half: int, iters: int, eps: float, min_eig: float,
):
    """One pyramid level of inverse-compositional KLT.

    uv0: [N, 2] template positions in img0 (this level's scale);
    uv1: [N, 2] current guesses in img1. Returns (uv1', cond_ok, residual).
    """
    N = uv0.shape[0]
    win = 2 * half + 1
    # window offset grid [win*win]
    dv, du = jnp.meshgrid(
        jnp.arange(-half, half + 1, dtype=jnp.float32),
        jnp.arange(-half, half + 1, dtype=jnp.float32),
        indexing="ij",
    )
    du = du.reshape(-1)
    dv = dv.reshape(-1)

    u0 = uv0[:, 0:1] + du[None, :]   # [N, P]
    v0 = uv0[:, 1:2] + dv[None, :]

    # template intensities and gradients (central differences in img0)
    T = _bilinear(img0, u0, v0)
    gx = 0.5 * (_bilinear(img0, u0 + 1.0, v0) - _bilinear(img0, u0 - 1.0, v0))
    gy = 0.5 * (_bilinear(img0, u0, v0 + 1.0) - _bilinear(img0, u0, v0 - 1.0))

    # normal matrix per keypoint
    gxx = jnp.sum(gx * gx, axis=1)
    gxy = jnp.sum(gx * gy, axis=1)
    gyy = jnp.sum(gy * gy, axis=1)
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    # min eigenvalue of 2x2 G, normalized per pixel like OpenCV
    min_eig_val = (trace - jnp.sqrt(jnp.maximum(trace * trace - 4 * det, 0.0))) \
        * 0.5 / (win * win)
    cond_ok = min_eig_val > min_eig

    det_safe = jnp.where(jnp.abs(det) < 1e-6, 1e-6, det)
    iG = (
        jnp.stack(
            [
                jnp.stack([gyy, -gxy], axis=-1),
                jnp.stack([-gxy, gxx], axis=-1),
            ],
            axis=-2,
        )
        / det_safe[:, None, None]
    )  # [N, 2, 2]

    def body(_, uv):
        u1 = uv[:, 0:1] + du[None, :]
        v1 = uv[:, 1:2] + dv[None, :]
        I = _bilinear(img1, u1, v1)
        err = I - T                              # [N, P]
        # ZERO-MEAN residuals (bias-invariant KLT): a camera gain/bias
        # drift between the template keyframe and the current frame adds a
        # near-constant offset to every window pixel; raw SSD turns that
        # offset into a spurious gradient-correlated step that walks the
        # track off the true corner. Subtracting the window-mean error
        # removes the photometric DC term exactly (standard zero-mean
        # SSD), leaving the geometric misalignment signal.
        err = err - jnp.mean(err, axis=1, keepdims=True)
        bx = jnp.sum(err * gx, axis=1)
        by = jnp.sum(err * gy, axis=1)
        b = jnp.stack([bx, by], axis=-1)         # [N, 2]
        delta = -jnp.einsum("nij,nj->ni", iG, b)
        # freeze ill-conditioned tracks
        delta = jnp.where(cond_ok[:, None], delta, 0.0)
        step = jnp.linalg.norm(delta, axis=-1, keepdims=True)
        delta = jnp.where(step < eps, 0.0, delta)
        return uv + delta

    uv1 = jax.lax.fori_loop(0, iters, body, uv1)

    # final residual + template contrast (for the normalized residual
    # gate). The gate residual stays RAW |I - T| (unlike the zero-meaned
    # solve): the DC term between the anchor template and a frame a few
    # steps later is tiny under realistic exposure drift, but a large DC
    # offset is a legitimate mistrack signal the gate must keep.
    I = _bilinear(img1, uv1[:, 0:1] + du[None, :], uv1[:, 1:2] + dv[None, :])
    residual = jnp.mean(jnp.abs(I - T), axis=1)
    t_mean = jnp.mean(T, axis=1)
    t_std = jnp.sqrt(jnp.maximum(
        jnp.mean(T * T, axis=1) - t_mean * t_mean, 0.0))
    return uv1, cond_ok, residual, t_std


def auto_track(*args, **kwargs) -> "FlowResult":
    """LK for the default backend: the Triton kernel (`lk_gpu.track`, with
    its per-block early exit) on a GPU, `track` elsewhere."""
    if jax.default_backend() == "gpu":
        from ya_vo_tpu.tracking import lk_gpu

        return lk_gpu.track(*args, **kwargs)
    return track(*args, **kwargs)


@functools.partial(
    jax.jit,
    static_argnames=("levels", "half", "iters", "eps", "min_eig",
                     "max_residual", "rel_residual"),
)
def track(
    img0: jnp.ndarray,
    img1: jnp.ndarray,
    uv0: jnp.ndarray,
    uv_init: jnp.ndarray,
    mask: jnp.ndarray,
    *,
    levels: int = 3,
    half: int = 5,             # 11x11 window (reference LoopHandler.cc:372)
    iters: int = 30,
    eps: float = 0.01,
    min_eig: float = 1e-3,
    max_residual: float = 12.0,
    rel_residual: float = 0.5,
) -> FlowResult:
    """Track keypoints uv0 from img0 to img1.

    Args:
      img0, img1: [H, W] uint8 or float32 images.
      uv0: [N, 2] keypoint positions in img0.
      uv_init: [N, 2] initial guesses in img1 (projection-seeded, like the
        reference's OPTFLOW_USE_INITIAL_FLOW-style seeding).
      mask: [N] bool valid keypoints.

    The residual gate is CONTRAST-NORMALIZED: a track passes if
    residual < max(max_residual, rel_residual * std(template)). Measured on
    a real KITTI photograph (tests/test_real_images.py), a perfectly tracked
    high-contrast window leaves mean |I - T| up to ~0.38 * std(T) from
    resampling blur alone, while a 4 px mistrack leaves >= 0.70 * std(T);
    an absolute threshold cannot separate the two (good p95 = 22 vs bad
    p10 = 21.7 intensity levels). `max_residual` survives as the absolute
    floor for low-contrast windows.
    """
    img0 = img0.astype(jnp.float32)
    img1 = img1.astype(jnp.float32)
    H, W = img0.shape
    pyr0 = build_pyramid(img0, levels)
    pyr1 = build_pyramid(img1, levels)

    scale_top = 2.0 ** (levels - 1)
    uv = uv_init / scale_top
    cond_all = jnp.ones(uv0.shape[0], bool)
    residual = jnp.zeros(uv0.shape[0], jnp.float32)
    t_std = jnp.zeros(uv0.shape[0], jnp.float32)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        uv, cond_ok, residual, t_std = _track_level(
            pyr0[lvl], pyr1[lvl], uv0 / s, uv, half, iters, eps, min_eig
        )
        cond_all = cond_all & cond_ok
        if lvl > 0:
            uv = uv * 2.0

    in_bounds = (
        (uv[:, 0] >= half) & (uv[:, 0] < W - half)
        & (uv[:, 1] >= half) & (uv[:, 1] < H - half)
    )
    gate = jnp.maximum(max_residual, rel_residual * t_std)
    status = mask & cond_all & in_bounds & (residual < gate)
    return FlowResult(uv=uv, status=status, residual=residual)
