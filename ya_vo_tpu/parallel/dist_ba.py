"""Distributed sliding-window BA: landmark shards x psum-reduced camera system.

Scaling story (BASELINE.json north star; the reference is single-process
C++ with no distributed anything, SURVEY.md §5): bundle adjustment's
structure is embarrassingly parallel in the LANDMARK dimension once the
camera system is Schur-reduced —

  * observations are stored landmark-major [L, W]: landmark l observed in
    window keyframe w at obs_uv[l, w] (at most one observation per
    (landmark, keyframe), so the layout is dense and static);
  * the landmark axis L is sharded over the mesh with `shard_map`; each
    device builds its shard's Hll (3x3), Wpl (6x3 per pose), landmark
    gradients, and its PARTIAL reduced camera system S_partial [W,6,W,6],
    b_partial [W,6];
  * one `psum` over the mesh produces the exact global reduced system —
    the only cross-device traffic is O((6W)^2) floats per GN iteration
    (an all-reduce over NVLink on a GPU host);
  * the dense [6W, 6W] solve is replicated (cheap); landmark
    back-substitution is local to each shard.

Poses are replicated; landmarks never leave their device.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ya_vo_tpu.core import lie
from ya_vo_tpu.core.camera import Camera


class DistBAProblem(NamedTuple):
    """Landmark-major BA problem (see module docstring for layout)."""

    poses: jnp.ndarray      # [W, 4, 4] world->camera (replicated)
    landmarks: jnp.ndarray  # [L, 3] (sharded on L)
    lm_valid: jnp.ndarray   # [L] bool
    obs_uv: jnp.ndarray     # [L, W, 2]
    obs_valid: jnp.ndarray  # [L, W] bool


def from_window_problem(prob) -> DistBAProblem:
    """Convert a keyframe-major `ba.window.BAProblem` (obs [W, O]) to the
    landmark-major layout (host-side, numpy)."""
    W = int(prob.poses.shape[0])
    L = int(prob.landmarks.shape[0])
    obs_uv = np.zeros((L, W, 2), np.float32)
    obs_valid = np.zeros((L, W), bool)
    kf_lm = np.asarray(prob.obs_lm)
    kf_uv = np.asarray(prob.obs_uv)
    kf_ok = np.asarray(prob.obs_valid)
    for w in range(W):
        ok = kf_ok[w] & (kf_lm[w] >= 0)
        lm = kf_lm[w][ok]
        obs_uv[lm, w] = kf_uv[w][ok]
        obs_valid[lm, w] = True
    return DistBAProblem(
        poses=jnp.asarray(np.asarray(prob.poses)),
        landmarks=jnp.asarray(np.asarray(prob.landmarks)),
        lm_valid=jnp.asarray(np.asarray(prob.lm_valid)),
        obs_uv=jnp.asarray(obs_uv),
        obs_valid=jnp.asarray(obs_valid),
    )


def _shard_terms(poses, landmarks, lm_valid, obs_uv, obs_valid, cam: Camera,
                 huber_delta: float, count_axis=None):
    """Per-observation terms in the landmark-major layout.
    Shapes: r [L, W, 2], Jp [L, W, 2, 6], Jl [L, W, 2, 3], w [L, W].

    count_axis: mesh axis name to psum the per-landmark observation count
    over, for callers whose local W axis is only a block of the window
    (the 2-D kf x lm solver); None when the local W axis is complete."""
    R = poses[None, :, :3, :3]                    # [1, W, 3, 3]
    t = poses[None, :, :3, 3]
    X = landmarks[:, None, :]                     # [L, 1, 3]
    pc = jnp.einsum("lwij,lwj->lwi",
                    jnp.broadcast_to(R, (X.shape[0], R.shape[1], 3, 3)),
                    jnp.broadcast_to(X, (X.shape[0], R.shape[1], 3))) + t
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    valid = obs_valid & lm_valid[:, None] & (z > 1e-2)
    # a landmark needs >= 2 usable observations to be part of the problem:
    # with one, its position is unconstrained along the ray and its
    # (damped-singular) Hll^-1 corrupts the reduced camera system
    n_obs = jnp.sum(valid, axis=1, keepdims=True)
    if count_axis is not None:
        n_obs = jax.lax.psum(n_obs, count_axis)
    valid = valid & (n_obs >= 2)
    z_safe = jnp.where(z < 1e-2, 1e-2, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    r = jnp.stack([u, v], axis=-1) - obs_uv

    zeros = jnp.zeros_like(x)
    J_proj = jnp.stack(
        [
            jnp.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], axis=-1),
            jnp.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], axis=-1),
        ],
        axis=-2,
    )  # [L, W, 2, 3]
    Jp_point = jnp.concatenate(
        [
            jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape + (3,)),
            -lie.hat(pc),
        ],
        axis=-1,
    )  # [L, W, 3, 6]
    Jp = jnp.einsum("lwij,lwjk->lwik", J_proj, Jp_point,
                    preferred_element_type=jnp.float32)
    Jl = jnp.einsum("lwij,wjk->lwik", J_proj, poses[:, :3, :3],
                    preferred_element_type=jnp.float32)

    chi2 = jnp.sum(r * r, axis=-1)
    nrm = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    w_huber = jnp.minimum(1.0, huber_delta / nrm)
    w = w_huber * valid.astype(r.dtype)
    huber_cost = jnp.where(
        nrm <= huber_delta, 0.5 * chi2,
        huber_delta * (nrm - 0.5 * huber_delta))
    cost = jnp.sum(jnp.where(valid, huber_cost, 0.0))
    return r, Jp, Jl, w, cost


def make_dist_solver(
    mesh: Mesh,
    cam: Camera,
    *,
    axis: str = "lm",
    iters: int = 8,
    huber_delta: float = 2.4477,
    damping: float = 1e-4,
    n_fixed_poses: int = 1,
    pose_prior_weight: float = 0.0,
):
    """Build a jitted distributed window-BA solver over `mesh`.

    Returns solve(problem) -> (poses [W,4,4], landmarks [L,3], cost0, cost1).
    The landmark axis of the problem must be divisible by the mesh size.
    `n_fixed_poses` pins the gauge like ba/window.solve_window: one pose
    fixes SE(3), a second also pins the monocular scale gauge (the live
    backend uses 2 — see Frontend._run_window_ba). `pose_prior_weight` is
    the same trust-region pose prior as solve_window's (see its docstring
    for the forward-motion scale-mode rationale); poses are replicated so
    the prior is computed identically on every device."""

    def shard_body(poses, landmarks, lm_valid, obs_uv, obs_valid):
        """Runs per-device on a landmark shard; poses replicated."""
        W = poses.shape[0]
        init_inv = jnp.linalg.inv(poses)

        def prior_dev(poses_q):
            return jax.vmap(lie.se3_log)(poses_q @ init_inv)

        def prior_cost(poses_q):
            if pose_prior_weight <= 0:
                return jnp.float32(0.0)
            d = prior_dev(poses_q)
            return 0.5 * pose_prior_weight * jnp.sum(d * d)

        def lm_cost_rows(poses_q, lms_q):
            """Per-landmark robust costs [Ls] (+ their local sum)."""
            r_q, _, _, w_q, _ = _shard_terms(
                poses_q, lms_q, lm_valid, obs_uv, obs_valid,
                cam, huber_delta)
            chi2q = jnp.sum(r_q * r_q, axis=-1)
            nq = jnp.sqrt(jnp.maximum(chi2q, 1e-12))
            hc = jnp.where(nq <= huber_delta, 0.5 * chi2q,
                           huber_delta * (nq - 0.5 * huber_delta))
            return jnp.sum(jnp.where(w_q > 0, hc, 0.0), axis=1)

        def gn_iter(_, state):
            poses_i, lms_i = state
            r, Jp, Jl, w, cost_prev_local = _shard_terms(
                poses_i, lms_i, lm_valid, obs_uv, obs_valid, cam, huber_delta)
            JpW = Jp * w[..., None, None]
            # local partials of the reduced system
            Hpp = jnp.einsum("lwia,lwib->wab", Jp, JpW,
                             preferred_element_type=jnp.float32)
            bp = -jnp.einsum("lwik,lwi->wk", JpW, r,
                             preferred_element_type=jnp.float32)
            Hll = jnp.einsum("lwik,lwim->lkm", Jl, Jl * w[..., None, None],
                             preferred_element_type=jnp.float32)  # [Ls, 3, 3]
            bl = -jnp.einsum("lwik,lwi->lk", Jl * w[..., None, None], r,
                             preferred_element_type=jnp.float32)
            Wpl = jnp.einsum("lwik,lwim->lwkm", JpW, Jl,
                             preferred_element_type=jnp.float32)  # [Ls,W,6,3]

            Hll_inv = jnp.linalg.inv(
                Hll + damping * jnp.eye(3, dtype=Hll.dtype))
            S_off = jnp.einsum("lwik,lkm,lvjm->wivj", Wpl, Hll_inv, Wpl,
                               preferred_element_type=jnp.float32)
            eyeW = jnp.eye(W, dtype=r.dtype)
            S_part = jnp.einsum("wv,wkl->wkvl", eyeW, Hpp) - S_off
            b_part = bp - jnp.einsum("lwik,lkm,lm->wi", Wpl, Hll_inv, bl,
                                     preferred_element_type=jnp.float32)

            # ---- THE collective: exact global reduced system ----
            S = jax.lax.psum(S_part, axis)
            b = jax.lax.psum(b_part, axis)

            # gauge + damping, replicated dense solve
            pin = jnp.zeros((W,), S.dtype)
            for i in range(n_fixed_poses):
                pin = pin.at[i].set(1e8)
            S = S + jnp.einsum("w,kl,wv->wkvl", pin,
                               jnp.eye(6, dtype=S.dtype),
                               jnp.eye(W, dtype=S.dtype))
            S = S + damping * jnp.einsum(
                "wv,kl->wkvl", jnp.eye(W, dtype=S.dtype),
                jnp.eye(6, dtype=S.dtype))
            if pose_prior_weight > 0:
                S = S + pose_prior_weight * jnp.einsum(
                    "wv,kl->wkvl", jnp.eye(W, dtype=S.dtype),
                    jnp.eye(6, dtype=S.dtype))
                b = b - pose_prior_weight * prior_dev(poses_i)
            dxp = jnp.linalg.solve(
                S.reshape(W * 6, W * 6), b.reshape(-1)).reshape(W, 6)
            ok = jnp.all(jnp.isfinite(dxp))
            dxp = jnp.where(ok, dxp, 0.0)
            for i in range(n_fixed_poses):  # hard gauge
                dxp = dxp.at[i].set(0.0)

            # local landmark back-substitution
            rhs = bl - jnp.einsum("lwik,wi->lk", Wpl, dxp,
                                  preferred_element_type=jnp.float32)
            dxl = jnp.einsum("lkm,lm->lk", Hll_inv, rhs,
                             preferred_element_type=jnp.float32)
            dxl = jnp.where(ok & lm_valid[:, None], dxl, 0.0)
            dxl = jnp.clip(dxl, -5.0, 5.0)

            new_poses = lie.se3_exp(dxp) @ poses_i
            cand_lms = lms_i + dxl

            # per-landmark acceptance (local; landmark-major layout makes
            # the per-landmark cost a plain sum over the W axis): weakly-
            # observed landmarks must not poison the whole step. The two
            # evaluations also yield the exact mixed-configuration cost
            # (per-landmark costs partition the total).
            lmA = lm_cost_rows(new_poses, cand_lms)
            lmB = lm_cost_rows(new_poses, lms_i)
            better = lmA <= lmB
            new_lms = jnp.where(better[:, None], cand_lms, lms_i)
            mixed_cost = jax.lax.psum(jnp.sum(jnp.minimum(lmA, lmB)), axis) \
                + prior_cost(new_poses)

            # accept-if-better on the GLOBAL cost for the pose step
            # (cost_prev came free with the linearization; prior is
            # replicated — added once, outside the psum)
            cost_prev = jax.lax.psum(cost_prev_local, axis) \
                + prior_cost(poses_i)
            accept = mixed_cost < cost_prev
            poses_i = jnp.where(accept, new_poses, poses_i)
            lms_i = jnp.where(accept, new_lms, lms_i)
            return poses_i, lms_i

        *_, cost0 = _shard_terms(poses, landmarks, lm_valid, obs_uv,
                                 obs_valid, cam, huber_delta)
        cost0 = jax.lax.psum(cost0, axis)
        poses, landmarks = jax.lax.fori_loop(
            0, iters, gn_iter, (poses, landmarks))
        *_, cost1 = _shard_terms(poses, landmarks, lm_valid, obs_uv,
                                 obs_valid, cam, huber_delta)
        cost1 = jax.lax.psum(cost1, axis)
        return poses, landmarks, cost0, cost1

    mapped = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(axis), P(), P()),
    )

    @jax.jit
    def solve(prob: DistBAProblem):
        # full f32 matmul precision: GN normal equations cancel heavily and
        # reduced-precision (TF32) input rounding stalls convergence
        with jax.default_matmul_precision("float32"):
            return mapped(prob.poses, prob.landmarks, prob.lm_valid,
                          prob.obs_uv, prob.obs_valid)

    return solve


def make_dist_solver_2d(
    mesh: Mesh,
    cam: Camera,
    *,
    kf_axis: str = "kf",
    lm_axis: str = "lm",
    iters: int = 8,
    huber_delta: float = 2.4477,
    damping: float = 1e-4,
    n_fixed_poses: int = 1,
    pose_prior_weight: float = 0.0,
):
    """2-D distributed window BA: keyframe BLOCKS x landmark SHARDS.

    The "map blocks over the mesh" layout (BASELINE.json north star): the
    window's keyframe axis W is partitioned into Pk blocks and the landmark
    axis L into Pl shards over a 2-D mesh (parallel/mesh.map_mesh). Each
    device owns the observation TILE [L/Pl, W/Pk] — both Jacobian work and
    observation storage scale 1/(Pk*Pl), which is what lets the window (and
    eventually the whole map) outgrow one chip's HBM.

    Per GN iteration, per device, the collectives are:
      * psum over kf: per-landmark obs counts, Hll [Ls,3,3], bl [Ls,3]
      * all_gather over kf: Wpl rows [Ls, W, 6, 3] (the dominant transfer —
        it stays within a kf column of the mesh)
      * psum over lm + all_gather over kf: reduced camera rows -> S [W6,W6]
      * replicated dense solve, local landmark back-substitution
    `collective_bytes_per_iter` prices these exactly for the scaling bench.

    Requires W % Pk == 0 and L % Pl == 0.
    """
    Pk, Pl = mesh.shape[kf_axis], mesh.shape[lm_axis]

    def shard_body(poses, landmarks, lm_valid, obs_uv, obs_valid):
        Wk = poses.shape[0]           # local keyframe block
        W = Wk * Pk                   # global window
        idx = jax.lax.axis_index(kf_axis)
        col0 = idx * Wk               # this block's global column offset
        init_inv = jnp.linalg.inv(poses)   # own block's input poses

        def prior_dev_own(poses_q):
            return jax.vmap(lie.se3_log)(poses_q @ init_inv)   # [Wk, 6]

        def prior_cost(poses_q):
            """Global prior cost (replicated result): psum over kf blocks."""
            if pose_prior_weight <= 0:
                return jnp.float32(0.0)
            d = prior_dev_own(poses_q)
            return 0.5 * pose_prior_weight * jax.lax.psum(
                jnp.sum(d * d), kf_axis)

        def terms(poses_q, lms_q):
            return _shard_terms(poses_q, lms_q, lm_valid, obs_uv, obs_valid,
                                cam, huber_delta, count_axis=kf_axis)

        def lm_cost_rows(poses_q, lms_q):
            """Per-landmark robust cost over the FULL window row [Ls]."""
            r_q, _, _, w_q, _ = terms(poses_q, lms_q)
            chi2q = jnp.sum(r_q * r_q, axis=-1)
            nq = jnp.sqrt(jnp.maximum(chi2q, 1e-12))
            hc = jnp.where(nq <= huber_delta, 0.5 * chi2q,
                           huber_delta * (nq - 0.5 * huber_delta))
            local = jnp.sum(jnp.where(w_q > 0, hc, 0.0), axis=1)
            return jax.lax.psum(local, kf_axis)

        def gn_iter(_, state):
            poses_i, lms_i = state
            r, Jp, Jl, w, cost_prev_local = terms(poses_i, lms_i)
            JpW = Jp * w[..., None, None]
            # landmark system: exact over the window via psum on kf
            Hll = jax.lax.psum(
                jnp.einsum("lwik,lwim->lkm", Jl, Jl * w[..., None, None],
                           preferred_element_type=jnp.float32), kf_axis)
            bl = jax.lax.psum(
                -jnp.einsum("lwik,lwi->lk", Jl * w[..., None, None], r,
                            preferred_element_type=jnp.float32), kf_axis)
            Hll_inv = jnp.linalg.inv(
                Hll + damping * jnp.eye(3, dtype=Hll.dtype))

            Wpl_own = jnp.einsum("lwik,lwim->lwkm", JpW, Jl,
                                 preferred_element_type=jnp.float32)
            # dominant collective: each landmark's pose-landmark coupling rows
            # for the WHOLE window (rides one kf column of the mesh)
            Wpl_full = jax.lax.all_gather(Wpl_own, kf_axis, axis=1,
                                          tiled=True)     # [Ls, W, 6, 3]

            # reduced camera system, rows for this kf block
            Hpp = jnp.einsum("lwia,lwib->wab", Jp, JpW,
                             preferred_element_type=jnp.float32)  # [Wk,6,6]
            eyeWk = jnp.eye(Wk, dtype=r.dtype)
            diag_rows = jnp.zeros((Wk, 6, W, 6), r.dtype)
            diag_rows = jax.lax.dynamic_update_slice(
                diag_rows, jnp.einsum("wv,wkl->wkvl", eyeWk, Hpp),
                (0, 0, col0, 0))
            S_off_rows = jnp.einsum("lwik,lkm,lvjm->wivj", Wpl_own, Hll_inv,
                                    Wpl_full,
                                    preferred_element_type=jnp.float32)
            S_rows = jax.lax.psum(diag_rows - S_off_rows, lm_axis)
            b_rows = jax.lax.psum(
                -jnp.einsum("lwik,lwi->wk", JpW, r,
                            preferred_element_type=jnp.float32)
                - jnp.einsum("lwik,lkm,lm->wi", Wpl_own, Hll_inv, bl,
                             preferred_element_type=jnp.float32), lm_axis)
            S = jax.lax.all_gather(S_rows, kf_axis, axis=0,
                                   tiled=True)             # [W, 6, W, 6]
            b = jax.lax.all_gather(b_rows, kf_axis, axis=0, tiled=True)
            if pose_prior_weight > 0:
                S = S + pose_prior_weight * jnp.einsum(
                    "wv,kl->wkvl", jnp.eye(W, dtype=S.dtype),
                    jnp.eye(6, dtype=S.dtype))
                dev_full = jax.lax.all_gather(
                    prior_dev_own(poses_i), kf_axis, axis=0, tiled=True)
                b = b - pose_prior_weight * dev_full

            # gauge + damping, replicated dense solve
            pin = jnp.zeros((W,), S.dtype)
            for i in range(n_fixed_poses):
                pin = pin.at[i].set(1e8)
            S = S + jnp.einsum("w,kl,wv->wkvl", pin,
                               jnp.eye(6, dtype=S.dtype),
                               jnp.eye(W, dtype=S.dtype))
            S = S + damping * jnp.einsum(
                "wv,kl->wkvl", jnp.eye(W, dtype=S.dtype),
                jnp.eye(6, dtype=S.dtype))
            dxp = jnp.linalg.solve(
                S.reshape(W * 6, W * 6), b.reshape(-1)).reshape(W, 6)
            ok = jnp.all(jnp.isfinite(dxp))
            dxp = jnp.where(ok, dxp, 0.0)
            for i in range(n_fixed_poses):  # hard gauge
                dxp = dxp.at[i].set(0.0)

            # local landmark back-substitution (identical across a kf column
            # — Wpl_full/bl/Hll_inv are, so lms stay consistent)
            rhs = bl - jnp.einsum("lwik,wi->lk", Wpl_full, dxp,
                                  preferred_element_type=jnp.float32)
            dxl = jnp.einsum("lkm,lm->lk", Hll_inv, rhs,
                             preferred_element_type=jnp.float32)
            dxl = jnp.where(ok & lm_valid[:, None], dxl, 0.0)
            dxl = jnp.clip(dxl, -5.0, 5.0)

            dxp_own = jax.lax.dynamic_slice(dxp, (col0, 0), (Wk, 6))
            new_poses = lie.se3_exp(dxp_own) @ poses_i
            cand_lms = lms_i + dxl

            lmA = lm_cost_rows(new_poses, cand_lms)
            lmB = lm_cost_rows(new_poses, lms_i)
            better = lmA <= lmB
            new_lms = jnp.where(better[:, None], cand_lms, lms_i)
            # lmA/lmB are full-window rows (already psum'd over kf): reduce
            # over lm only; result is identical on every device
            mixed_cost = jax.lax.psum(jnp.sum(jnp.minimum(lmA, lmB)),
                                      lm_axis) + prior_cost(new_poses)

            cost_prev = jax.lax.psum(cost_prev_local, (kf_axis, lm_axis)) \
                + prior_cost(poses_i)
            accept = mixed_cost < cost_prev
            poses_i = jnp.where(accept, new_poses, poses_i)
            lms_i = jnp.where(accept, new_lms, lms_i)
            return poses_i, lms_i

        *_, cost0 = terms(poses, landmarks)
        cost0 = jax.lax.psum(cost0, (kf_axis, lm_axis))
        poses, landmarks = jax.lax.fori_loop(
            0, iters, gn_iter, (poses, landmarks))
        *_, cost1 = terms(poses, landmarks)
        cost1 = jax.lax.psum(cost1, (kf_axis, lm_axis))
        return poses, landmarks, cost0, cost1

    # the replication checker can't see that landmark updates are identical
    # across the kf axis (Wpl_full/Hll/bl all come out of kf collectives)
    # and pose updates identical across lm — disable it (check_vma on new
    # jax, check_rep on older)
    kw = {}
    try:
        import inspect
        params = inspect.signature(jax.shard_map).parameters
        kw = {"check_vma": False} if "check_vma" in params else \
             {"check_rep": False}
    except (TypeError, ValueError):
        kw = {"check_rep": False}
    mapped = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(kf_axis), P(lm_axis), P(lm_axis),
                  P(lm_axis, kf_axis), P(lm_axis, kf_axis)),
        out_specs=(P(kf_axis), P(lm_axis), P(), P()),
        **kw,
    )

    @jax.jit
    def solve(prob: DistBAProblem):
        with jax.default_matmul_precision("float32"):
            return mapped(prob.poses, prob.landmarks, prob.lm_valid,
                          prob.obs_uv, prob.obs_valid)

    return solve


def collective_bytes_per_iter(
    W: int, L: int, n_kf: int = 1, n_lm: int = 1
) -> dict:
    """Logical collective payload per device per GN iteration, in bytes,
    for the 1-D (n_kf=1) and 2-D solvers. Ring-algorithm wire traffic per
    device is ~2(N-1)/N x payload for all-reduce and (N-1)/N x result for
    all-gather; both factors are applied in `ring_bytes`."""
    f32 = 4
    Ls = L // n_lm
    Wk = W // n_kf

    def ring_ar(payload, n):   # all-reduce, ring
        return 2 * (n - 1) / max(n, 1) * payload

    def ring_ag(result, n):    # all-gather, ring: receive the rest
        return (n - 1) / max(n, 1) * result

    if n_kf == 1:
        psum_payload = (36 * W * W + 6 * W + 4) * f32    # S + b + scalars
        return {
            "psum_bytes": psum_payload,
            "gather_bytes": 0,
            "ring_bytes": ring_ar(psum_payload, n_lm),
        }
    # 2-D: per _shard_terms call there is an n_obs psum [Ls] (3 calls/iter)
    psum_kf = (3 * Ls * f32                               # n_obs counts
               + (9 + 3) * Ls * f32                       # Hll + bl
               + 2 * Ls * f32)                            # lmA/lmB rows
    psum_lm = (36 * Wk * W + 6 * W + 4) * f32             # S rows + b + costs
    gather_kf = (Ls * W * 18 * f32                        # Wpl_full
                 + (36 * W * W + 6 * W) * f32)            # S + b rows
    return {
        "psum_bytes": psum_kf + psum_lm,
        "gather_bytes": gather_kf,
        "ring_bytes": (ring_ar(psum_kf, n_kf) + ring_ar(psum_lm, n_lm)
                       + ring_ag(gather_kf, n_kf)),
    }
