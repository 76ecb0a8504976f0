"""Two-view epipolar geometry: normalized 8-point F/E, decomposition, checks.

Fully batched rework of the reference's `_3DHandler`
(reference: src/3DHandler.cc). Key correspondences:

* `normalize_points`  <- Hartley normalization (`getMeanVar` 3DHandler.cc:17-25,
  `constructNormMatrix` :28-47).
* `eight_point`       <- Nx9 DLT + null vector + rank-2 enforcement
  (`getFundamentalMatrix` 3DHandler.cc:50-142). Batched over hypotheses: the
  null vector comes from eigh of A^T A (9x9, symmetric) instead of SVD of A —
  same math, friendlier to large batches.
* `essential_from_fundamental` <- E = K2^T F K1.
* `decompose_essential` <- the four (R, t) candidates (`disambiguateRT`
  3DHandler.cc:199-388) via the standard U W V^T construction — NOT the
  reference's rotateMatrixZ, which passes degrees to radian cos/sin
  (quirk SURVEY.md §2.4.3; fixed here by construction).
* `sampson_error` / `epipolar_error` <- inlier scoring (the reference scores
  RANSAC by algebraic error x2^T F x1, 3DHandler.cc:165-183; Sampson is the
  better-conditioned choice and is what we threshold in pixels).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def to_homogeneous(pts: jnp.ndarray) -> jnp.ndarray:
    """[..., N, 2] -> [..., N, 3] with unit last coordinate."""
    return jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)


def normalize_points(pts: jnp.ndarray, mask: jnp.ndarray):
    """Hartley normalization: translate masked centroid to origin, scale mean
    distance to sqrt(2). Returns (pts_norm [..., N, 2], T [..., 3, 3])."""
    w = mask.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1.0)
    mean = jnp.sum(pts * w[..., None], axis=-2, keepdims=True) / n[..., None]
    centered = (pts - mean) * w[..., None]
    dist = jnp.linalg.norm(centered, axis=-1)
    mean_dist = jnp.sum(dist, axis=-1, keepdims=True) / jnp.squeeze(n, -1)[..., None]
    scale = jnp.sqrt(2.0) / jnp.maximum(mean_dist, 1e-8)  # [..., 1]
    pts_norm = centered * scale[..., None]

    s = scale[..., 0]
    mu, mv = mean[..., 0, 0], mean[..., 0, 1]
    zeros = jnp.zeros_like(s)
    ones = jnp.ones_like(s)
    T = jnp.stack(
        [
            jnp.stack([s, zeros, -s * mu], axis=-1),
            jnp.stack([zeros, s, -s * mv], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )
    return pts_norm, T


def _smallest_eigvec_9(M: jnp.ndarray) -> jnp.ndarray:
    """Eigenvector of the smallest eigenvalue of symmetric [..., 9, 9]."""
    _, vecs = jnp.linalg.eigh(M)  # ascending eigenvalues
    return vecs[..., :, 0]


def eight_point(pts1: jnp.ndarray, pts2: jnp.ndarray, mask: jnp.ndarray):
    """Normalized 8-point fundamental matrix, batched.

    Args:
      pts1, pts2: [..., N, 2] pixel correspondences (N >= 8; masked rows
        ignored via zero weights).
      mask: [..., N] bool.
    Returns:
      F: [..., 3, 3] with rank-2 enforced, denormalized, f33-normalized.
    """
    p1n, T1 = normalize_points(pts1, mask)
    p2n, T2 = normalize_points(pts2, mask)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = jnp.ones_like(x1)
    # row_i = [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1]
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1
    )  # [..., N, 9]
    A = A * mask[..., None].astype(A.dtype)
    AtA = jnp.einsum("...ni,...nj->...ij", A, A)
    f = _smallest_eigvec_9(AtA)
    F = f.reshape(f.shape[:-1] + (3, 3))

    # rank-2 enforcement via batched 3x3 SVD
    U, S, Vt = jnp.linalg.svd(F)
    S2 = S.at[..., 2].set(0.0)
    F = U @ (S2[..., :, None] * Vt)

    # denormalize: F = T2^T F T1
    F = jnp.swapaxes(T2, -1, -2) @ F @ T1
    norm = jnp.linalg.norm(F.reshape(F.shape[:-2] + (9,)), axis=-1)
    return F / jnp.maximum(norm, 1e-12)[..., None, None]


def epipolar_error(F: jnp.ndarray, pts1: jnp.ndarray, pts2: jnp.ndarray):
    """Algebraic error |x2^T F x1| per correspondence [..., N]."""
    x1 = to_homogeneous(pts1)
    x2 = to_homogeneous(pts2)
    Fx1 = jnp.einsum("...ij,...nj->...ni", F, x1)
    return jnp.abs(jnp.sum(x2 * Fx1, axis=-1))


def sampson_error(F: jnp.ndarray, pts1: jnp.ndarray, pts2: jnp.ndarray):
    """First-order geometric (Sampson) error in pixels, [..., N]."""
    x1 = to_homogeneous(pts1)
    x2 = to_homogeneous(pts2)
    Fx1 = jnp.einsum("...ij,...nj->...ni", F, x1)   # [..., N, 3]
    Ftx2 = jnp.einsum("...ji,...nj->...ni", F, x2)
    num = jnp.sum(x2 * Fx1, axis=-1) ** 2
    den = (
        Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
        + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    )
    return num / jnp.maximum(den, 1e-12)


def essential_from_fundamental(F: jnp.ndarray, K1: jnp.ndarray, K2: jnp.ndarray):
    """E = K2^T F K1."""
    return jnp.swapaxes(K2, -1, -2) @ F @ K1


def decompose_essential(E: jnp.ndarray):
    """E -> 4 candidate (R [..., 4, 3, 3], t [..., 4, 3]) world->cam2 motions.

    Standard construction: E = U diag(1,1,0) V^T;
    R in {U W V^T, U W^T V^T}, t in {+u3, -u3}, with det(R) sign-corrected.
    """
    U, _, Vt = jnp.linalg.svd(E)
    # make proper rotations possible: flip sign if det < 0
    detU = jnp.linalg.det(U)
    detVt = jnp.linalg.det(Vt)
    U = U * jnp.where(detU < 0, -1.0, 1.0)[..., None, None]
    Vt = Vt * jnp.where(detVt < 0, -1.0, 1.0)[..., None, None]

    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    Ra = U @ W @ Vt
    Rb = U @ jnp.swapaxes(W, -1, -2) @ Vt
    t = U[..., :, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12)

    Rs = jnp.stack([Ra, Ra, Rb, Rb], axis=-3)
    ts = jnp.stack([t, -t, t, -t], axis=-2)
    return Rs, ts
