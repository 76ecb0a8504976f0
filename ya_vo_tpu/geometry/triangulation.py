"""Batched two-view DLT triangulation.

Replaces the reference's per-point SVD loop (reference:
src/LoopHandler.cc:867-885 `triangulation` — 4x4 DLT solved per landmark
inside a C++ loop, with an INVERTED quality gate, SURVEY.md §2.4.2) with one
batched eigendecomposition over all correspondences: the null vector of A
comes from eigh of A^T A (4x4 symmetric — better batched than SVD), and the quality gate keeps points where the smallest singular value is
well-separated (sigma3/sigma2 < ratio), i.e. the CORRECT orientation of the
reference's test.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def triangulate(
    P1: jnp.ndarray,
    P2: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    mask: jnp.ndarray,
    quality_ratio: float = 1e-2,
    min_depth: float = 0.1,
    max_depth: float = 500.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """DLT-triangulate correspondences.

    Args:
      P1, P2: [3, 4] (or batched [..., 3, 4]) projection matrices K[R|t].
      uv1, uv2: [..., N, 2] pixel coords in view 1 / 2.
      mask: [..., N] bool valid correspondences.
      quality_ratio: keep points with lambda_min / lambda_3 below this
        (eigenvalues of A^T A, ascending: lambda0 smallest).
      min_depth, max_depth: cheirality/depth gate in CAMERA-1 frame... depth
        here is measured via the homogeneous solution's w-normalized z in
        each camera; both cameras must see the point in front.

    Returns:
      points_w: [..., N, 3] world points (garbage where invalid).
      valid: [..., N] bool — input mask AND quality AND positive-depth gates.
    """
    with jax.default_matmul_precision("float32"):
        return _triangulate(P1, P2, uv1, uv2, mask, quality_ratio,
                            min_depth, max_depth)


def _triangulate(P1, P2, uv1, uv2, mask, quality_ratio, min_depth,
                 max_depth):
    # full f32 matmul precision (set by the wrapper): DLT depth is a ratio
    # of near-cancelling terms and reduced-precision input rounding
    # poisons it
    # Build A [..., N, 4, 4] with rows u*P[2]-P[0], v*P[2]-P[1] per view
    u1 = uv1[..., 0]
    v1 = uv1[..., 1]
    u2 = uv2[..., 0]
    v2 = uv2[..., 1]

    def row(P, coord, idx):
        # coord [..., N], P [..., 3, 4] -> [..., N, 4]
        return coord[..., None] * P[..., None, 2, :] - P[..., None, idx, :]

    rows = jnp.broadcast_arrays(
        row(P1, u1, 0), row(P1, v1, 1), row(P2, u2, 0), row(P2, v2, 1)
    )
    A = jnp.stack(rows, axis=-2)  # [..., N, 4, 4]

    AtA = jnp.einsum("...ki,...kj->...ij", A, A)
    eigvals, eigvecs = jnp.linalg.eigh(AtA)  # ascending
    X = eigvecs[..., :, 0]  # [..., N, 4] null vector

    w = X[..., 3]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    pts = X[..., :3] / w_safe[..., None]

    # quality: smallest eigenvalue well separated from the next
    # (sqrt of eigvals of AtA = singular values of A)
    sigma0 = jnp.sqrt(jnp.maximum(eigvals[..., 0], 0.0))
    sigma1 = jnp.sqrt(jnp.maximum(eigvals[..., 1], 1e-20))
    good_quality = (sigma0 / sigma1) < quality_ratio

    # cheirality in both views: depth = (P[2] . X~) with X~ = [pts, 1]
    Xh = jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)
    z1 = jnp.einsum("...j,...nj->...n", P1[..., 2, :], Xh)
    z2 = jnp.einsum("...j,...nj->...n", P2[..., 2, :], Xh)
    # P = K[R|t] has positive-definite K scale on row 3 => z is metric depth
    good_depth = (
        (z1 > min_depth) & (z1 < max_depth) & (z2 > min_depth) & (z2 < max_depth)
    )

    valid = mask & good_quality & good_depth
    return pts, valid


def triangulate_fast(
    P1: jnp.ndarray,
    P2: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    mask: jnp.ndarray,
    min_depth: float = 0.1,
    max_depth: float = 500.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Closed-form inhomogeneous DLT triangulation (hot-path variant).

    Same 4-row DLT system as `triangulate` but solved with w=1 fixed:
    A[:, :3] X = -A[:, 3], via 3x3 normal equations + Cramer's rule — pure
    elementwise math, no batched eigh (whose iterative sweeps would
    dominate the fused tracking step). The w=1 chart loses only points at infinity,
    which the depth gates reject anyway. Callers that need the homogeneous
    null vector + sigma-ratio quality gate (two-view bootstrap) keep using
    `triangulate`; hot-path callers gate on reprojection error instead
    (reference quality gate: src/LoopHandler.cc:867-885, inverted-return
    bug fixed per SURVEY §2.4.2).

    Returns (points_w [..., N, 3], valid [..., N]).
    """
    with jax.default_matmul_precision("float32"):
        u1 = uv1[..., 0]
        v1 = uv1[..., 1]
        u2 = uv2[..., 0]
        v2 = uv2[..., 1]

        def row(P, coord, idx):
            return (coord[..., None] * P[..., None, 2, :]
                    - P[..., None, idx, :])

        rows = jnp.broadcast_arrays(
            row(P1, u1, 0), row(P1, v1, 1), row(P2, u2, 0), row(P2, v2, 1))
        A = jnp.stack(rows, axis=-2)            # [..., N, 4, 4]
        M = A[..., :3]                          # [..., N, 4, 3]
        b = -A[..., 3]                          # [..., N, 4]
        # 3x3 normal equations G X = h
        G = jnp.einsum("...ki,...kj->...ij", M, M)
        h = jnp.einsum("...ki,...k->...i", M, b)
        # Cramer's rule via the adjugate (all elementwise)
        g00, g01, g02 = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
        g11, g12, g22 = G[..., 1, 1], G[..., 1, 2], G[..., 2, 2]
        c00 = g11 * g22 - g12 * g12
        c01 = g02 * g12 - g01 * g22
        c02 = g01 * g12 - g02 * g11
        c11 = g00 * g22 - g02 * g02
        c12 = g01 * g02 - g00 * g12
        c22 = g00 * g11 - g01 * g01
        det = g00 * c00 + g01 * c01 + g02 * c02
        finite = jnp.abs(det) > 1e-12
        det_safe = jnp.where(finite, det, 1.0)
        h0, h1, h2 = h[..., 0], h[..., 1], h[..., 2]
        pts = jnp.stack([
            (c00 * h0 + c01 * h1 + c02 * h2) / det_safe,
            (c01 * h0 + c11 * h1 + c12 * h2) / det_safe,
            (c02 * h0 + c12 * h1 + c22 * h2) / det_safe,
        ], axis=-1)

        Xh = jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)
        z1 = jnp.einsum("...j,...nj->...n", P1[..., 2, :], Xh)
        z2 = jnp.einsum("...j,...nj->...n", P2[..., 2, :], Xh)
        good_depth = ((z1 > min_depth) & (z1 < max_depth)
                      & (z2 > min_depth) & (z2 < max_depth))
        return pts, mask & finite & good_depth


def reprojection_errors(
    P: jnp.ndarray, pts_w: jnp.ndarray, uv: jnp.ndarray
) -> jnp.ndarray:
    """Pixel reprojection error [..., N] of world points through P [..., 3, 4]."""
    Xh = jnp.concatenate([pts_w, jnp.ones_like(pts_w[..., :1])], axis=-1)
    proj = jnp.einsum("...ij,...nj->...ni", P, Xh)
    z = jnp.where(jnp.abs(proj[..., 2]) < 1e-9, 1e-9, proj[..., 2])
    uv_hat = proj[..., :2] / z[..., None]
    return jnp.linalg.norm(uv_hat - uv, axis=-1)
