"""Synthetic scenes and image sequences for tests and benchmarks.

The reference repo tests against a local KITTI download that is absent here
(reference: tests/UtilsTest.cc:19 hardcodes an absolute dataset path). This
module replaces that with fully reproducible synthetic data:

* `random_landmarks` / `project_tracks`: exact geometry (known R|t and 3-D
  points) for triangulation / RANSAC / pose-solver tests — ground truth is
  closed-form, no rendering involved.
* `render_scene`: a corner-rich grayscale renderer (axis-aligned bright
  squares splatted at projected landmark positions, size ~ 1/depth) so the
  full FAST -> BRIEF -> match -> E -> triangulate -> GN pipeline can be run
  end-to-end with known ground-truth trajectory.
"""

from __future__ import annotations

import functools


import numpy as np

from ya_vo_tpu.core.camera import Camera


def kitti_camera() -> Camera:
    """The KITTI gray-camera intrinsics used throughout the reference
    (reference tests/calib.txt:1; src/LoopHandler.cc:570-571)."""
    return Camera.create(718.856, 718.856, 607.1928, 185.2157)


def random_landmarks(
    n: int, seed: int = 0,
    x_range=(-15.0, 15.0), y_range=(-4.0, 3.0), z_range=(6.0, 60.0),
) -> np.ndarray:
    """[n, 3] world points in front of the initial camera."""
    rng = np.random.default_rng(seed)
    pts = np.stack(
        [
            rng.uniform(*x_range, n),
            rng.uniform(*y_range, n),
            rng.uniform(*z_range, n),
        ],
        axis=-1,
    )
    return pts.astype(np.float32)


def forward_trajectory(n_frames: int, step: float = 0.8,
                       yaw_rate: float = 0.0) -> np.ndarray:
    """[n, 4, 4] world->camera poses for a camera moving along +z with
    optional constant yaw (KITTI-like forward motion)."""
    poses = np.zeros((n_frames, 4, 4), dtype=np.float32)
    yaw = 0.0
    pos = np.zeros(3)
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R_cw = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])  # cam->world
        R = R_cw.T
        t = -R @ pos
        poses[i, :3, :3] = R
        poses[i, :3, 3] = t
        poses[i, 3, 3] = 1.0
        pos = pos + R_cw @ np.array([0.0, 0.0, step])
        yaw += yaw_rate
    return poses


def project_tracks(
    landmarks: np.ndarray, poses_wc: np.ndarray, cam: Camera,
    height: int, width: int, margin: int = 20,
):
    """Project every landmark into every frame.

    Returns (uv [F, N, 2] float32, vis [F, N] bool) — vis requires positive
    depth and in-bounds projection with `margin`.
    """
    F = poses_wc.shape[0]
    N = landmarks.shape[0]
    uv = np.zeros((F, N, 2), dtype=np.float32)
    vis = np.zeros((F, N), dtype=bool)
    fx = float(cam.fx); fy = float(cam.fy)
    cx = float(cam.cx); cy = float(cam.cy)
    for f in range(F):
        R = poses_wc[f, :3, :3]
        t = poses_wc[f, :3, 3]
        pc = landmarks @ R.T + t
        z = pc[:, 2]
        ok = z > 0.25
        zs = np.where(ok, z, 1.0)
        u = fx * pc[:, 0] / zs + cx
        v = fy * pc[:, 1] / zs + cy
        uv[f] = np.stack([u, v], axis=-1)
        vis[f] = (
            ok & (u >= margin) & (u < width - margin)
            & (v >= margin) & (v < height - margin)
        )
    return uv, vis


_STAMP_HALF = 8  # stamp is (2*_STAMP_HALF+1)^2


def _landmark_stamp(index: int, seed: int) -> np.ndarray:
    """Deterministic per-landmark texture stamp [17, 17] float32.

    A coarse random binary pattern (2x2-pixel cells, bright/dark) — corner-
    rich at the FAST ring scale (FAST-12 needs sharp, speckle-like structure;
    smooth 90-degree corners yield only 11 contiguous ring pixels and never
    fire) and unique per landmark so BRIEF descriptors are discriminative.
    """
    side = 2 * _STAMP_HALF + 1
    rng = np.random.default_rng(seed * 100003 + index)
    cells = rng.choice([0.0, 1.0], size=(side // 2 + 1, side // 2 + 1),
                       p=[0.55, 0.45])
    pattern = np.kron(cells, np.ones((2, 2)))[:side, :side]
    level = rng.uniform(170, 250)
    return pattern * level


@functools.lru_cache(maxsize=16384)
def _stamp_shift_views(index: int, seed: int):
    """The stamp plus its three 1-px-rolled variants (for the bilinear
    subpixel shift), cached: regenerating the rng + kron per (landmark,
    frame) dominated render_scene's cost — 48k rng constructions for a
    40-frame bench sequence on a 2-core host."""
    stamp = _landmark_stamp(index, seed)
    side = stamp.shape[0]
    pad = np.zeros((side + 1, side + 1), np.float32)
    pad[:side, :side] = stamp
    p00 = pad[:side, :side]
    p01 = np.roll(pad, 1, axis=1)[:side, :side]
    p10 = np.roll(pad, 1, axis=0)[:side, :side]
    p11 = np.roll(np.roll(pad, 1, 0), 1, 1)[:side, :side]
    return stamp, p00.copy(), p01.copy(), p10.copy(), p11.copy()


def render_scene(
    landmarks: np.ndarray, pose_wc: np.ndarray, cam: Camera,
    height: int, width: int, seed: int = 3,
    background: int = 25, subpixel: bool = True,
) -> np.ndarray:
    """Render one frame: each visible landmark's unique texture stamp is
    drawn centered at its projection. uint8 [H, W].

    With `subpixel` (default) the stamp is bilinearly shifted by the
    fractional part of the projection, so inter-frame motion carries true
    subpixel information — without it, stamps snap to integer pixels and
    optical-flow errors are dominated by rendering quantization rather
    than the tracker.
    """
    rng = np.random.default_rng(seed)
    img = np.full((height, width), background, dtype=np.float32)
    img += rng.normal(0.0, 1.5, size=img.shape)  # mild sensor noise

    R = pose_wc[:3, :3]
    t = pose_wc[:3, 3]
    pc = landmarks @ R.T + t
    z = pc[:, 2]
    order = np.argsort(-z)  # far first, near overwrites
    h = _STAMP_HALF
    for i in order:
        zi = z[i]
        if zi <= 0.25:
            continue
        uf = float(cam.fx) * pc[i, 0] / zi + float(cam.cx)
        vf = float(cam.fy) * pc[i, 1] / zi + float(cam.cy)
        u, v = int(np.floor(uf)), int(np.floor(vf))
        if u < h + 1 or v < h + 1 or u >= width - h - 2 or v >= height - h - 2:
            continue
        stamp, p00, p01, p10, p11 = _stamp_shift_views(int(i), seed)
        if subpixel:
            au, av = uf - u, vf - v
            # bilinear shift of the stamp (precomputed rolled views)
            shifted = (
                (1 - au) * (1 - av) * p00
                + au * (1 - av) * p01
                + (1 - au) * av * p10
                + au * av * p11
            )
            region = img[v - h:v + h + 1, u - h:u + h + 1]
            img[v - h:v + h + 1, u - h:u + h + 1] = np.where(
                shifted > 8.0, shifted, region)
        else:
            region = img[v - h:v + h + 1, u - h:u + h + 1]
            img[v - h:v + h + 1, u - h:u + h + 1] = np.where(
                stamp > 0, stamp, region)
    return np.clip(img, 0, 255).astype(np.uint8)


def render_sequence(
    n_frames: int = 8, n_landmarks: int = 400,
    height: int = 376, width: int = 1241,
    step: float = 0.6, yaw_rate: float = 0.0, seed: int = 0,
    corridor: bool = False,
):
    """Full synthetic sequence: (images [F] list of uint8 [H, W],
    poses_wc [F, 4, 4], landmarks [N, 3], cam).

    With `corridor` (default), landmarks are distributed along the whole
    travel path (z up to travel + 60 m) so fresh features keep entering the
    field of view as old ones pass behind the camera — feature lifetimes
    then resemble a real driving sequence instead of a fixed point cloud
    the camera drives out of.
    """
    cam = kitti_camera()
    z_far = 60.0 + (step * n_frames if corridor else 0.0)
    lms = random_landmarks(n_landmarks, seed=seed, z_range=(6.0, z_far))
    poses = forward_trajectory(n_frames, step=step, yaw_rate=yaw_rate)
    imgs = [
        render_scene(lms, poses[f], cam, height, width, seed=seed + 11)
        for f in range(n_frames)
    ]
    return imgs, poses, lms, cam


def window_problem(seed=0, W=5, L=200, noise=0.0, pose_pert=0.02,
                   lm_pert=0.10, O=256):
    """A window-BA problem with known answer: `L` random landmarks seen
    from `W` forward-moving poses (at most `O` observations per keyframe),
    every pose but the first and every landmark perturbed.

    Returns (prob: ba.window.BAProblem, cam, poses_gt, landmarks_gt)."""
    import jax.numpy as jnp

    from ya_vo_tpu.ba import window
    from ya_vo_tpu.core import lie

    rng = np.random.default_rng(seed)
    cam = kitti_camera()
    lms = random_landmarks(L, seed=seed)
    poses = forward_trajectory(W, step=0.5)
    uv, vis = project_tracks(lms, poses, cam, 376, 1241, margin=5)
    if noise > 0:
        uv = uv + rng.normal(0, noise, uv.shape).astype(np.float32)

    obs_uv = np.zeros((W, O, 2), np.float32)
    obs_lm = np.full((W, O), -1, np.int32)
    obs_valid = np.zeros((W, O), bool)
    for w in range(W):
        ids = np.nonzero(vis[w])[0][:O]
        obs_uv[w, : len(ids)] = uv[w, ids]
        obs_lm[w, : len(ids)] = ids
        obs_valid[w, : len(ids)] = True

    poses_pert = poses.copy()
    for w in range(1, W):
        xi = rng.normal(0, pose_pert, 6).astype(np.float32)
        poses_pert[w] = np.asarray(
            lie.se3_exp(jnp.asarray(xi))) @ poses_pert[w]
    lms_pert = lms + rng.normal(0, lm_pert, lms.shape).astype(np.float32)

    prob = window.BAProblem(
        poses=jnp.asarray(poses_pert),
        pose_valid=jnp.ones(W, bool),
        landmarks=jnp.asarray(lms_pert),
        lm_valid=jnp.ones(L, bool),
        obs_uv=jnp.asarray(obs_uv),
        obs_lm=jnp.asarray(obs_lm),
        obs_valid=jnp.asarray(obs_valid),
    )
    return prob, cam, poses, lms
