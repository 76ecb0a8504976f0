"""Diagnose the production-gate primary bench workload: run bench.py's
exact primary loop ONCE with per-frame telemetry, and print where the
inlier margin thins, where resets/BA-discards happen, and the keyframe/BA
cadence around them.

Round-4 verdict item 3: the primary recorded 1 reset + 1 async-BA
staleness discard in 402 frames with ATE_sim3 0.2785 — this tool answers
"which gate, which frame, and why" so the fix targets the real mechanism.

Usage: python tools/diag_primary.py [--frames N] [--seed S] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

_REPO = __file__.rsplit("/", 2)[0]
sys.path.insert(0, _REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=410)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/diag_primary.json")
    ap.add_argument("--window", type=int, default=0,
                    help="override map.window_size")
    ap.add_argument("--every-n", type=int, default=0,
                    help="override ba.every_n_keyframes")
    ap.add_argument("--stale", type=int, default=0,
                    help="override ba.max_stale_keyframes")
    ap.add_argument("--prior", type=float, default=-1,
                    help="override ba.pose_prior_weight")
    ap.add_argument("--refine-sweep", action="store_true",
                    help="after the run, try offline-refine variants")
    ap.add_argument("--apply-mode", default="",
                    help="override ba.apply_mode (push|device)")
    ap.add_argument("--maxdepth", type=float, default=0,
                    help="override tracking.max_depth_baseline_ratio")
    ap.add_argument("--kf-trans", type=float, default=0,
                    help="override tracking.keyframe_max_translation")
    ap.add_argument("--sync", action="store_true",
                    help="synchronous BA: deterministic ATE for config "
                         "A/Bs (async apply timing varies from run to "
                         "run and drowns accuracy deltas)")
    a = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    import dataclasses

    import jax

    from ya_vo_tpu.config import VOConfig
    from ya_vo_tpu.tracking.frontend import Frontend
    from ya_vo_tpu.utils import compile_cache
    from ya_vo_tpu.utils.scene import TexturedSequence
    from ya_vo_tpu.viz import evaluation

    compile_cache.enable()
    N, WARM = a.frames, 8
    seq = TexturedSequence(n_frames=N, seed=a.seed)
    cfg = VOConfig()
    if a.window:
        cfg = dataclasses.replace(
            cfg, map=dataclasses.replace(cfg.map, window_size=a.window))
    if a.every_n:
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
            cfg.ba, every_n_keyframes=a.every_n))
    if a.stale:
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
            cfg.ba, max_stale_keyframes=a.stale))
    if a.prior >= 0:
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
            cfg.ba, pose_prior_weight=a.prior))
    if a.apply_mode:
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
            cfg.ba, apply_mode=a.apply_mode))
    if a.sync:
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
            cfg.ba, asynchronous=False))
    if a.maxdepth:
        cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(
            cfg.tracking, max_depth_baseline_ratio=a.maxdepth))
    if a.kf_trans:
        cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(
            cfg.tracking, keyframe_max_translation=a.kf_trans))
    fe = Frontend(cfg, seq.cam)

    rows = []

    def obs(res):
        rows.append(dict(
            f=res.frame_id, st=res.status, kp=res.n_keypoints,
            flow=res.n_flow_inliers, ba=res.n_ba_inliers,
            new=res.n_new_landmarks, kf=bool(res.is_keyframe),
            reset=bool(res.reset),
            # BA apply/discard counters at resolve time: correlates applies
            # with inlier-count jumps in the per-frame trace
            nba=fe.n_ba_runs, ndisc=fe.n_ba_discarded))

    fe.observers.append(obs)

    for f in range(WARM):
        fe.process(np.asarray(jax.device_get(seq.frame(f))))
    fe.precompile()
    t0 = time.perf_counter()
    fe.run((seq.frame(f) for f in range(WARM, N)), pipelined=True)
    jax.effects_barrier()
    dt = time.perf_counter() - t0

    gt_cw = np.linalg.inv(seq.poses[:N])
    est = np.stack(fe.trajectory)
    ate = float(evaluation.ate_rmse(est, gt_cw, with_scale=True))
    # per-frame sim3-aligned position error trace (where does drift grow?)
    err = evaluation.ate_trace(est, gt_cw)
    sd = evaluation.scale_drift(est, gt_cw)
    rpe_t, rpe_r = evaluation.rpe(est, gt_cw, delta=10)

    print(f"\n=== {fe.n_resets} resets, {fe.n_ba_runs} BA applies, "
          f"{fe.n_ba_discarded} BA discards, "
          f"{sum(r['kf'] for r in rows)} keyframes / {len(rows)} frames, "
          f"ATE_sim3={ate:.4f}, {((N - WARM) / dt):.2f} fps")
    print(f"scale_drift rms_log={sd['rms_log']:.4f}, rpe10 trans="
          f"{rpe_t:.4f} rot={rpe_r:.4f} deg "
          f"(cfg: W={cfg.map.window_size}, every_n="
          f"{cfg.ba.every_n_keyframes}, stale={cfg.ba.max_stale_keyframes},"
          f" prior={cfg.ba.pose_prior_weight})")

    ba = np.array([r["ba"] for r in rows if not r["reset"]])
    track = [r for r in rows if r["st"] == "TRACKING"]
    print(f"n_ba inliers over tracking frames: min={ba[ba > 0].min()} "
          f"p5={np.percentile(ba[ba > 0], 5):.0f} "
          f"median={np.median(ba[ba > 0]):.0f}")
    thin = [r for r in track if 0 < r["ba"] < 150]
    print(f"{len(thin)} frames with n_ba < 150 (gate 100):")
    for r in thin[:20]:
        print("  ", r)
    for i, r in enumerate(rows):
        if r["reset"]:
            lo, hi = max(0, i - 6), min(len(rows), i + 4)
            print(f"--- reset at frame {r['f']} (context {lo}..{hi}):")
            for rr in rows[lo:hi]:
                print("  ", rr)
    # drift growth: error at each decile of the route
    q = [round(float(np.percentile(err, p)), 3)
         for p in (10, 25, 50, 75, 90, 100)]
    print(f"sim3-aligned per-frame error deciles (10/25/50/75/90/max): {q}")
    # LOCAL scale along the route: windowed Sim(3) factors. A monotone
    # slope here (not the rms wander scale_drift reports) is systematic
    # monocular scale decay — the round-5 diagnosis of the primary's ATE
    locs = [evaluation.sim3_scale(est[a:a + 60], gt_cw[a:a + 60])
            for a in range(0, len(est) - 60, 60)]
    slope_pct = (locs[-1] / locs[0] - 1) * 100 if len(locs) > 1 else 0.0
    print(f"local sim3 scale by 60-frame window: "
          f"{[round(s, 4) for s in locs]}  (end/start: {slope_pct:+.2f}%)")

    if a.refine_sweep:
        import copy

        from ya_vo_tpu.ba.global_refine import global_refine

        kf_snap = fe.map.kf_pose[: fe.map.n_keyframes].copy()
        lm_snap = fe.map.landmark_pos.copy()
        for passes, prior, iters in ((2, 100.0, None), (2, 10.0, None),
                                     (2, 0.0, None), (4, 10.0, None),
                                     (2, 10.0, 24), (4, 0.0, 24)):
            fe.map.kf_pose[: fe.map.n_keyframes] = kf_snap
            fe.map.landmark_pos[:] = lm_snap
            c0 = fe.cfg
            fe.cfg = copy.deepcopy(c0)
            object.__setattr__(fe.cfg.ba, "offline_pose_prior_weight",
                               prior)
            try:
                traj_r = global_refine(fe, passes=passes, iters=iters)
            finally:
                fe.cfg = c0
            ate_r = float(evaluation.ate_rmse(traj_r, gt_cw,
                                              with_scale=True))
            print(f"refine passes={passes} prior={prior:5.1f} "
                  f"iters={iters}: ATE {ate:.4f} -> {ate_r:.4f}")
        fe.map.kf_pose[: fe.map.n_keyframes] = kf_snap
        fe.map.landmark_pos[:] = lm_snap

    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    np.savez(a.out + ".npz", est=est, gt_cw=gt_cw)
    with open(a.out, "w") as f:
        json.dump(dict(rows=rows, ate=ate,
                       scale_drift=sd["rms_log"], rpe10_t=rpe_t,
                       resets=fe.n_resets, discards=fe.n_ba_discarded), f)
    print(f"wrote {a.out} (+.npz trajectory)")


if __name__ == "__main__":
    main()
