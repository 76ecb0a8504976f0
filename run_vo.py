#!/usr/bin/env python
"""CLI runner: the `main()` of the framework.

Reference equivalent: src/main.cc constructs a LoopHandler from a config
path and spins the VO loop + viewer thread. Here:

    python run_vo.py --config configs/KITTI.json [--max-frames N]
        [--checkpoint out.npz] [--resume in.npz]
        [--traj out_poses.txt] [--plot traj.png] [--synthetic]

`--synthetic` runs the built-in synthetic KITTI-resolution sequence (no
dataset needed) and reports ATE against its ground truth.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="monocular visual odometry")
    ap.add_argument("--config", default=None, help="config JSON path")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--traj", default=None, help="KITTI-format pose output")
    ap.add_argument("--plot", default=None, help="trajectory PNG output")
    ap.add_argument("--checkpoint", default=None, help="save state npz")
    ap.add_argument("--resume", default=None, help="load state npz")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save every N frames (requires --checkpoint)")
    ap.add_argument("--refine", action="store_true",
                    help="offline full-map BA refinement before reporting")
    ap.add_argument("--synthetic", action="store_true",
                    help="run the built-in synthetic sequence")
    ap.add_argument("--synthetic-frames", type=int, default=30)
    ap.add_argument("--synthetic-size", type=int, nargs=2, default=[376, 1241],
                    metavar=("H", "W"))
    ap.add_argument("--live", type=int, default=None, metavar="PORT",
                    help="serve a live trajectory/map view on "
                         "http://127.0.0.1:PORT (0 = pick a free port)")
    args = ap.parse_args(argv)

    from ya_vo_tpu.utils import compile_cache

    # repeated runs skip recompilation
    compile_cache.enable()

    from ya_vo_tpu.config import VOConfig, TrackConfig
    from ya_vo_tpu.tracking.frontend import Frontend
    from ya_vo_tpu.utils import checkpoint as ckpt
    from ya_vo_tpu.viz import evaluation

    gt_cw = None
    if args.synthetic:
        from ya_vo_tpu.utils import synthetic

        H, W = args.synthetic_size
        imgs, poses_gt, lms, cam = synthetic.render_sequence(
            n_frames=args.synthetic_frames,
            n_landmarks=max(200, (H * W) // 400),
            height=H, width=W, step=0.4, yaw_rate=0.002, seed=11)
        gt_cw = np.linalg.inv(poses_gt)
        cfg = VOConfig(
            image_height=H, image_width=W,
            tracking=TrackConfig(min_ba_inliers=20, min_flow_inliers=5))
        frames = imgs
        n_frames = len(imgs)
    else:
        if not args.config:
            ap.error("--config required unless --synthetic")
        cfg = VOConfig.from_json(args.config)
        from ya_vo_tpu.io import kitti

        calib_path = f"{kitti.sequence_dir(cfg.base_path, cfg.sequence)}/calib.txt"
        left, _ = kitti.load_calib(calib_path)
        cam = left.camera()
        stream = kitti.ImageStream(cfg.base_path, cfg.sequence)
        frames = iter(stream)
        n_frames = len(stream)
        gt = kitti.load_gt_poses(cfg.base_path, cfg.sequence)
        gt_cw = gt if gt is not None else None

    fe = Frontend(cfg, cam)
    if args.live is not None:
        from ya_vo_tpu.viz import live

        viewer = live.attach(fe, port=args.live)
        print(f"[run_vo] live view: http://127.0.0.1:{viewer.port}/",
              file=sys.stderr)
    if args.resume:
        ckpt.load_frontend(fe, args.resume)
        print(f"[run_vo] resumed at frame {fe.frame_id}", file=sys.stderr)

    t0 = time.perf_counter()
    n_done = 0
    for i, img in enumerate(frames):
        if args.max_frames and n_done >= args.max_frames:
            break
        r = fe.process(np.asarray(img))
        n_done += 1
        if n_done % 50 == 0 or r.reset:
            el = time.perf_counter() - t0
            print(
                f"[run_vo] frame {r.frame_id} {r.status} "
                f"kp={r.n_keypoints} flow={r.n_flow_inliers} "
                f"ba={r.n_ba_inliers} map={fe.map.stats()['n_alive']} "
                f"({n_done/el:.1f} fps)",
                file=sys.stderr,
            )
        if (args.checkpoint and args.checkpoint_every
                and n_done % args.checkpoint_every == 0):
            ckpt.save_frontend(fe, args.checkpoint)

    dt = time.perf_counter() - t0
    traj = np.stack(fe.trajectory)
    if args.refine:
        from ya_vo_tpu.ba.global_refine import global_refine

        traj = global_refine(fe)

    summary = {
        "frames": int(len(traj)),
        "fps": round(len(traj) / dt, 2),
        "resets": int(fe.n_resets),
        "ba_runs": int(fe.n_ba_runs),
        **fe.map.stats(),
    }
    if gt_cw is not None:
        # both alignments: Sim(3) hides global scale error, SE(3) shows it
        summary["ate_sim3_m"] = round(
            evaluation.ate_rmse(traj, gt_cw, with_scale=True), 4)
        summary["ate_se3_m"] = round(
            evaluation.ate_rmse(traj, gt_cw, with_scale=False), 4)
        rpe_t, rpe_r = evaluation.rpe(traj, gt_cw)
        summary["rpe_trans_m"] = round(rpe_t, 4)
        summary["rpe_rot_deg"] = round(rpe_r, 4)
        drift = evaluation.scale_drift(traj, gt_cw)
        summary["scale_drift_rms_log"] = round(drift["rms_log"], 4)
        seg_t, seg_r, n_seg = evaluation.kitti_segment_errors(traj, gt_cw)
        if n_seg:
            summary["kitti_t_err_pct"] = round(seg_t, 3)
            summary["kitti_r_err_deg_per_m"] = round(seg_r, 5)

    if args.traj:
        from ya_vo_tpu.io.kitti import save_trajectory_kitti

        save_trajectory_kitti(args.traj, np.linalg.inv(traj))
    if args.plot:
        from ya_vo_tpu.viz import render

        pos, _ = fe.map.alive_landmarks()
        render.plot_trajectory(traj, gt_cw, pos, out_path=args.plot)
    if args.checkpoint:
        ckpt.save_frontend(fe, args.checkpoint)

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
