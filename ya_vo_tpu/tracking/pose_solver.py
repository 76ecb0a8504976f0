"""Pose-only bundle adjustment: robust Gauss-Newton on SE(3).

Replaces the reference's g2o pipeline (reference: src/LoopHandler.cc:730-861
`optimizePoseOnly` — one VertexPose + one unary reprojection edge per
feature, Huber kernel, 4 rounds x 10 LM iterations with chi2 > 5.991
outlier demotion) with a single jitted iteratively-reweighted GN solver:

  * residual r_i = project(T x_i) - uv_i, analytic 2x6 Jacobian (the same
    [-fx/Z, 0, fx X/Z^2, ...] block the reference hand-codes at
    include/Optimizer.hpp:108-126, in [v, w] tangent order);
  * Huber weights + hard chi2 gate as masked weights (replacing g2o's
    edge-level(1) outlier demotion, src/LoopHandler.cc:811-838);
  * H = sum_i J_i^T W_i J_i (6x6), b = -sum_i J_i^T W_i r_i as batched
    reductions; solve; LEFT-multiplicative update T <- exp(dx) T under
    `lax.fori_loop` with Levenberg damping.

All matmul-heavy steps carry explicit f32 accumulation so reduced-precision
(TF32) matmul defaults cannot degrade the normal equations.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ya_vo_tpu.core import lie
from ya_vo_tpu.core.camera import Camera


class PoseSolveResult(NamedTuple):
    pose: jnp.ndarray          # [4, 4] optimized world->camera pose
    inlier_mask: jnp.ndarray   # [N] bool chi2 inliers at the solution
    n_inliers: jnp.ndarray     # [] int32
    final_cost: jnp.ndarray    # [] f32 robust mean cost over valid obs


def _residuals_and_jacobian(T, pts_w, uv, cam: Camera):
    """r [N, 2], J [N, 2, 6] (d r / d xi, LEFT-multiplicative tangent),
    z [N] camera-frame depth."""
    pc = lie.transform_points(T, pts_w)           # [N, 3]
    X, Y, Z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = jnp.where(Z < 1e-3, 1e-3, Z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = cam.fx * X * inv_z + cam.cx
    v = cam.fy * Y * inv_z + cam.cy
    r = jnp.stack([u, v], axis=-1) - uv           # [N, 2]

    fx, fy = cam.fx, cam.fy
    zeros = jnp.zeros_like(X)
    # d(u,v)/d(pc) [N, 2, 3]
    J_proj = jnp.stack(
        [
            jnp.stack([fx * inv_z, zeros, -fx * X * inv_z2], axis=-1),
            jnp.stack([zeros, fy * inv_z, -fy * Y * inv_z2], axis=-1),
        ],
        axis=-2,
    )
    # d(pc)/d(xi) with T' = exp(xi) T: dpc = dv + dw x pc -> [I | -hat(pc)]
    J_point = jnp.concatenate(
        [
            jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3)),
            -lie.hat(pc),
        ],
        axis=-1,
    )  # [N, 3, 6]
    J = jnp.einsum("nij,njk->nik", J_proj, J_point,
                   preferred_element_type=jnp.float32)
    return r, J, Z


@functools.partial(jax.jit, static_argnames=("iters",))
def solve_pose(
    T_init: jnp.ndarray,
    pts_w: jnp.ndarray,
    uv: jnp.ndarray,
    mask: jnp.ndarray,
    cam: Camera,
    *,
    iters: int = 40,
    huber_delta: float = 2.4477,
    chi2_threshold: float = 5.991,
    damping: float = 1e-6,
) -> PoseSolveResult:
    """Robust pose-only GN.

    Args:
      T_init: [4, 4] initial world->camera pose (e.g. constant-velocity
        prior, reference src/LoopHandler.cc:138-140).
      pts_w: [N, 3] landmark positions.
      uv: [N, 2] observed pixels in this frame.
      mask: [N] bool valid observations.
      iters: total GN iterations (reference: 4 rounds x 10).
    """
    # geometry at full f32 matmul precision: reduced-precision inputs
    # floor the solve accuracy regardless of iterations
    with jax.default_matmul_precision("float32"):
        return _solve_pose(T_init, pts_w, uv, mask, cam, iters=iters,
                           huber_delta=huber_delta,
                           chi2_threshold=chi2_threshold, damping=damping)


def _solve_pose(T_init, pts_w, uv, mask, cam, *, iters, huber_delta,
                chi2_threshold, damping) -> PoseSolveResult:
    base_valid = mask

    def body(state):
        T, it, _ = state
        r, J, Z = _residuals_and_jacobian(T, pts_w, uv, cam)
        chi2 = jnp.sum(r * r, axis=-1)                        # [N]
        valid = base_valid & (Z > 1e-3)
        # Huber weight w = min(1, delta / |r|)
        norm = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        w_huber = jnp.minimum(1.0, huber_delta / norm)
        # soft chi2 gate: outliers get tiny (not zero) weight so they can
        # re-enter as the pose improves (replaces the 4-round re-gating)
        w_gate = jnp.where(chi2 > chi2_threshold, 1e-3, 1.0)
        w = w_huber * w_gate * valid.astype(r.dtype)          # [N]

        JW = J * w[:, None, None]
        H = jnp.einsum("nik,nil->kl", J, JW,
                       preferred_element_type=jnp.float32)    # [6, 6]
        b = -jnp.einsum("nik,ni->k", JW, r,
                        preferred_element_type=jnp.float32)   # [6]
        H = H + damping * jnp.eye(6, dtype=H.dtype)
        dx = jnp.linalg.solve(H, b)
        # guard divergent steps
        ok = jnp.all(jnp.isfinite(dx)) & (jnp.linalg.norm(dx) < 1.0)
        dx = jnp.where(ok, dx, jnp.zeros_like(dx))
        return lie.se3_exp(dx) @ T, it + 1, jnp.linalg.norm(dx)

    def cond(state):
        # early exit once the GN step is numerically negligible — a well-
        # seeded frame converges in < 10 iterations, and each iteration is
        # a full residual/Jacobian pass
        _, it, step = state
        return (it < iters) & (step > 1e-5)

    T, _, _ = jax.lax.while_loop(
        cond, body, (T_init, jnp.int32(0), jnp.float32(1.0)))

    r, _, Z = _residuals_and_jacobian(T, pts_w, uv, cam)
    chi2 = jnp.sum(r * r, axis=-1)
    valid = base_valid & (Z > 1e-3)
    inliers = valid & (chi2 <= chi2_threshold)
    n_inliers = jnp.sum(inliers).astype(jnp.int32)
    nrm = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    huber_cost = jnp.where(
        nrm <= huber_delta, 0.5 * chi2, huber_delta * (nrm - 0.5 * huber_delta)
    )
    denom = jnp.maximum(jnp.sum(valid), 1)
    final_cost = jnp.sum(jnp.where(valid, huber_cost, 0.0)) / denom
    return PoseSolveResult(
        pose=T, inlier_mask=inliers, n_inliers=n_inliers, final_cost=final_cost
    )
