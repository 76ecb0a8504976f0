"""Distributed-BA scaling harness.

Measures wall-clock per GN iteration of the distributed window BA
(parallel/dist_ba.py) across mesh shapes, reporting scaling efficiency
(BASELINE.json config #5: "map blocks sharded across hosts, distributed BA
via collectives"). Runs on whatever devices are visible — the virtual
8-device CPU mesh in tests, the GPUs of a host on hardware; the same code
path covers both (mesh + shard_map + psum/all_gather, which XLA hands to
NCCL on GPUs).

Besides measured wall-clock, every row prices the per-device collective
payload exactly (dist_ba.collective_bytes_per_iter). Virtual CPU meshes
share host cores, so their wall-clock says nothing about a GPU host.

Usage:
    python -m ya_vo_tpu.parallel.scaling_bench [L] [W]
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def build_problem(L: int, W: int, seed: int = 0):
    import jax.numpy as jnp

    from ya_vo_tpu.parallel.dist_ba import DistBAProblem
    from ya_vo_tpu.utils import synthetic

    cam = synthetic.kitti_camera()
    lms = synthetic.random_landmarks(L, seed=seed)
    poses = synthetic.forward_trajectory(W, step=0.5)
    uv, vis = synthetic.project_tracks(lms, poses, cam, 376, 1241, margin=5)
    rng = np.random.default_rng(seed + 1)
    lms_pert = lms + rng.normal(0, 0.05, lms.shape).astype(np.float32)
    return cam, DistBAProblem(
        poses=jnp.asarray(poses),
        landmarks=jnp.asarray(lms_pert),
        lm_valid=jnp.ones(L, bool),
        obs_uv=jnp.asarray(np.transpose(uv, (1, 0, 2)).astype(np.float32)),
        obs_valid=jnp.asarray(np.transpose(vis, (1, 0))),
    )


def measure(L: int = 16384, W: int = 8, iters: int = 4,
            device_counts: Optional[Sequence[int]] = None,
            mesh_shapes: Optional[Sequence[Tuple[int, int]]] = None,
            repeats: int = 3) -> List[Dict]:
    """Rows for 1-D landmark meshes (`device_counts`, n_kf=1) and/or 2-D
    kf x lm meshes (`mesh_shapes` as (n_kf, n_lm) pairs)."""
    import jax

    from ya_vo_tpu.parallel import dist_ba, mesh as mesh_lib

    n_dev = len(jax.devices())
    if device_counts is None and mesh_shapes is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    shapes: List[Tuple[int, int]] = [(1, d) for d in (device_counts or [])]
    shapes += list(mesh_shapes or [])

    cam, prob = build_problem(L, W)
    rows = []
    base = None
    for n_kf, n_lm in shapes:
        if n_kf * n_lm > n_dev or W % n_kf or L % n_lm:
            continue
        if n_kf == 1:
            mesh = mesh_lib.landmark_mesh(n_lm)
            solve = dist_ba.make_dist_solver(mesh, cam, iters=iters)
        else:
            mesh = mesh_lib.map_mesh(n_kf, n_lm)
            solve = dist_ba.make_dist_solver_2d(mesh, cam, iters=iters)
        out = solve(prob)
        jax.block_until_ready(out[0])  # compile + warm
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = solve(prob)
        jax.block_until_ready(out[0])
        dt = (time.perf_counter() - t0) / repeats / iters
        if base is None:
            base = dt
        n = n_kf * n_lm
        coll = dist_ba.collective_bytes_per_iter(W, L, n_kf, n_lm)
        rows.append({
            "mesh": f"{n_kf}x{n_lm}",
            "devices": n,
            "ms_per_gn_iter": round(dt * 1e3, 3),
            "speedup": round(base / dt, 3),
            "efficiency": round(base / dt / n, 3),
            "collective_mb_per_iter": round(coll["ring_bytes"] / 2**20, 3),
        })
    return rows


if __name__ == "__main__":
    import json
    import sys

    L = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    W = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    two_d = [(2, 4), (4, 2), (2, 2), (8, 1)]
    for row in measure(L, W, mesh_shapes=two_d):
        print(json.dumps(row))
