"""SO(3) / SE(3) Lie-group operations in pure jnp.

Pure-jnp replacement for the reference's Sophus usage (reference:
include/Optimizer.hpp:51-57 `VertexPose::oplusImpl` uses a *left*-multiplicative
se(3) update `T <- exp(dx) * T`; src/LoopHandler.cc:619-648 composes SE3 poses
and inverses). Everything here is batched: all ops broadcast over leading axes
so they can be `vmap`-ed / used inside `lax.scan` without shape surgery.

Conventions
-----------
* Poses are 4x4 homogeneous matrices `T` with `T[..., :3, :3] = R`,
  `T[..., :3, 3] = t`, representing world->camera maps `x_cam = R x_w + t`
  (same convention as the reference's `Frame::pose`, include/Frame.hpp:18-25).
* se(3) tangent vectors are `xi = [v, w]` with translation part first and
  rotation part last (Sophus ordering, matching the analytic Jacobian layout
  in reference include/Optimizer.hpp:108-126).
* Updates are LEFT-multiplicative: `T_new = se3_exp(xi) @ T`.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of a batch of 3-vectors: [..., 3] -> [..., 3, 3]."""
    zeros = jnp.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of `hat`: [..., 3, 3] -> [..., 3]."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta_sq: jnp.ndarray):
    """Return (A, B, C) = (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3).

    Taylor expansions keep the small-angle branch exact-to-float32 and, more
    importantly, keep gradients finite at theta == 0 (jnp.where on both
    branches evaluates both, so the naive form would produce NaN grads).
    """
    small = theta_sq < 1e-8
    # `where` evaluates both branches; feed the exact branch a safe argument
    # so its gradient stays finite at theta == 0 (double-where trick).
    safe_sq = jnp.where(small, jnp.ones_like(theta_sq), theta_sq)
    theta = jnp.sqrt(safe_sq)
    a_exact = jnp.sin(theta) / theta
    b_exact = (1.0 - jnp.cos(theta)) / safe_sq
    c_exact = (theta - jnp.sin(theta)) / (safe_sq * theta)
    a_taylor = 1.0 - theta_sq / 6.0
    b_taylor = 0.5 - theta_sq / 24.0
    c_taylor = 1.0 / 6.0 - theta_sq / 120.0
    A = jnp.where(small, a_taylor, a_exact)
    B = jnp.where(small, b_taylor, b_exact)
    C = jnp.where(small, c_taylor, c_exact)
    return A, B, C


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: [..., 3] rotation vector -> [..., 3, 3] matrix."""
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> rotation vector. [..., 3, 3] -> [..., 3].

    Stable away from theta == pi (clamped); VO frame-to-frame rotations are
    far from pi, so the near-pi branch is handled only approximately by the
    symmetric-part extraction below.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0)
    theta = jnp.arccos(cos_theta)
    theta_sq = theta * theta
    A, _, _ = _sinc_coeffs(theta_sq)
    # w_hat = theta / (2 sin theta) * (R - R^T); for small theta use series.
    factor = 0.5 / jnp.maximum(A, 1e-6)
    W = factor[..., None, None] * (R - jnp.swapaxes(R, -1, -2))
    return vee(W)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) exponential map: [..., 6] tangent (v first, w last) -> [..., 4, 4]."""
    v, w = xi[..., :3], xi[..., 3:]
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, C = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    # Left Jacobian V: t = V v.
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, v)
    return rt_to_mat(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) logarithm: [..., 4, 4] -> [..., 6] tangent (v first, w last)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, C = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    v = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def rt_to_mat(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble [..., 4, 4] homogeneous transforms from R [..., 3, 3], t [..., 3]."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )
    return jnp.concatenate([top, bottom[..., None, :]], axis=-2)


def se3_inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of [..., 4, 4] rigid transforms."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_mat(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def se3_compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """A @ B for batched 4x4 transforms."""
    return A @ B


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply [..., 4, 4] to points [..., N, 3] (or [..., 3]) -> same shape."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if pts.ndim == T.ndim:  # [..., N, 3] against T [..., 4, 4]
        return jnp.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]
    return jnp.einsum("...ij,...j->...i", R, pts) + t


def se3_identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)
