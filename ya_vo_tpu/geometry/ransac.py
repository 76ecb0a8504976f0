"""Vectorized RANSAC for the essential/fundamental matrix, plus full
two-view relative-pose recovery.

The reference runs a 400-iteration sequential loop, each solving an 8-point
system with OpenCV SVD (reference: src/3DHandler.cc:145-195 `getFRANSAC`),
then throws the result away and calls cv::findEssentialMat + recoverPose
(src/LoopHandler.cc:567-598, quirk SURVEY.md §2.4.5). Here the whole thing
is one jitted computation (SURVEY.md §7.1 "vmap for hypotheses"):

  * K hypotheses' 8-point samples drawn in one batched masked Gumbel top-k
    (sampling without replacement, no host loop);
  * `eight_point` vmapped over the hypothesis axis;
  * inliers counted with a batched Sampson-error reduction; argmax selects;
  * final F refit on ALL inliers of the best hypothesis (the step OpenCV's
    RANSAC does internally);
  * E = K^T F K, 4-way decomposition, batched-triangulation cheirality vote
    (replacing recoverPose, and doing `disambiguateRT` 3DHandler.cc:199-388
    with correct math).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ya_vo_tpu.core import lie
from ya_vo_tpu.geometry import epipolar
from ya_vo_tpu.geometry.triangulation import triangulate


class TwoViewResult(NamedTuple):
    F: jnp.ndarray            # [3, 3] fundamental
    E: jnp.ndarray            # [3, 3] essential
    R: jnp.ndarray            # [3, 3] rotation cam1->cam2 (x2 = R x1 + t)
    t: jnp.ndarray            # [3] unit translation
    inlier_mask: jnp.ndarray  # [N] bool epipolar inliers
    n_inliers: jnp.ndarray    # [] int32
    points: jnp.ndarray       # [N, 3] triangulated points (cam1 frame)
    points_valid: jnp.ndarray # [N] bool
    n_cheirality: jnp.ndarray # [] int32 — votes for the winning candidate


def _sample_indices(key, n_hyp: int, sample_size: int, mask: jnp.ndarray):
    """[n_hyp, sample_size] indices drawn without replacement from valid
    entries of `mask` via Gumbel top-k (invalid entries get -inf weight)."""
    n = mask.shape[0]
    g = jax.random.gumbel(key, (n_hyp, n))
    g = jnp.where(mask[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, sample_size)
    return idx


@functools.partial(
    jax.jit,
    static_argnames=("n_hypotheses", "sample_size"),
)
def estimate_two_view(
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    mask: jnp.ndarray,
    K: jnp.ndarray,
    key: jnp.ndarray,
    *,
    n_hypotheses: int = 512,
    sample_size: int = 8,
    inlier_threshold_px: float = 1.0,
) -> TwoViewResult:
    """Full robust two-view geometry from matched pixels.

    Args:
      uv1, uv2: [N, 2] matched pixel coordinates (masked).
      mask: [N] bool valid matches.
      K: [3, 3] shared intrinsics.
      key: PRNG key.
    """
    with jax.default_matmul_precision("float32"):
        return _estimate_two_view(
            uv1, uv2, mask, K, key, n_hypotheses=n_hypotheses,
            sample_size=sample_size,
            inlier_threshold_px=inlier_threshold_px)


def _estimate_two_view(uv1, uv2, mask, K, key, *, n_hypotheses, sample_size,
                       inlier_threshold_px) -> TwoViewResult:
    # full f32 matmul precision (set by the public wrapper): epipolar
    # algebra is catastrophically sensitive to reduced-precision input
    # rounding
    N = uv1.shape[0]
    fmask = mask.astype(uv1.dtype)

    # --- hypothesis generation ------------------------------------------
    idx = _sample_indices(key, n_hypotheses, sample_size, mask)  # [K, 8]
    s1 = uv1[idx]                       # [K, 8, 2]
    s2 = uv2[idx]
    smask = jnp.ones(idx.shape, bool)
    F_h = epipolar.eight_point(s1, s2, smask)            # [K, 3, 3]

    # --- scoring ---------------------------------------------------------
    err = epipolar.sampson_error(F_h, uv1[None], uv2[None])  # [K, N]
    thr = inlier_threshold_px ** 2  # sampson_error returns squared px
    inl = (err < thr) & mask[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)

    # --- refit on all inliers of the best hypothesis ---------------------
    best_inl = inl[best]
    F = epipolar.eight_point(uv1, uv2, best_inl)
    err_f = epipolar.sampson_error(F, uv1, uv2)
    inlier_mask = (err_f < thr) & mask
    # guard: refit can only replace the hypothesis if it keeps >= as many
    n_refit = jnp.sum(inlier_mask)
    use_refit = n_refit >= scores[best]
    F = jnp.where(use_refit, F, F_h[best])
    inlier_mask = jnp.where(use_refit, inlier_mask, best_inl)
    n_inliers = jnp.sum(inlier_mask).astype(jnp.int32)

    # --- essential matrix + pose ----------------------------------------
    E = epipolar.essential_from_fundamental(F, K, K)
    Rs, ts = epipolar.decompose_essential(E)             # [4, 3, 3], [4, 3]

    # cheirality vote by batched triangulation of the inlier correspondences
    eye34 = jnp.concatenate([jnp.eye(3, dtype=K.dtype),
                             jnp.zeros((3, 1), K.dtype)], axis=1)
    P1 = K @ eye34                                       # [3, 4]
    Rt = jnp.concatenate([Rs, ts[..., None]], axis=-1)   # [4, 3, 4]
    P2 = K[None] @ Rt                                    # [4, 3, 4]

    pts_c, val_c = triangulate(
        P1[None], P2, uv1[None], uv2[None], inlier_mask[None]
    )  # [4, N, 3], [4, N]
    votes = jnp.sum(val_c, axis=1)                       # [4]
    win = jnp.argmax(votes)

    return TwoViewResult(
        F=F,
        E=E,
        R=Rs[win],
        t=ts[win],
        inlier_mask=inlier_mask,
        n_inliers=n_inliers,
        points=pts_c[win],
        points_valid=val_c[win],
        n_cheirality=votes[win].astype(jnp.int32),
    )


def relative_pose_to_se3(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R, t) with x2 = R x1 + t  ->  SE(3) T_21 (cam1->cam2) 4x4."""
    return lie.rt_to_mat(R, t)
