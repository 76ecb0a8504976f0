"""Benchmark: full-pipeline VO throughput at KITTI resolution, production
gates, textured imagery, on one GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
..., "device": {...}}; progress goes to stderr.

The figure (the JSON "value"): frames/s of the complete pipeline —
on-device ray-cast world render + fused FAST+Harris+BRIEF extraction +
projection-seeded pyramidal LK + robust pose GN + device-side keyframe
merge + synchronous windowed Schur BA — over a 402-frame timed window of
the seeded `TexturedSequence(seed=5)` route at the unmodified production
config (reference gates min_ba_inliers=100 / min_flow_inliers=2,
src/LoopHandler.cc:144,151). The timed window runs BENCH_REPS times
(default 3); the value is the median. `device_step_ms` is the fused
step's device time (`Frontend.device_throughput_probe`: 200 chained
steps, one block at the end).

`vs_baseline` is against the MEASURED reference rate: the reference
publishes no numbers (its README is a to-do list), so
`native/refbench/refbench.cc` re-implements its per-frame hot loops
faithfully (per-pixel scalar FAST re-deriving the Bresenham circle through
std::set, reference src/FastDetector.cc:277-369; per-bit popcount Hamming,
src/BriefDescriptor.cc:139-160) plus the exact cv::calcOpticalFlowPyrLK
call (src/LoopHandler.cc:372-375), timed on the reference's own real KITTI
frame on a host CPU: 3.22 fps, recorded in
native/refbench/BASELINE_MEASURED.json (method: BASELINE.md). The
reference number excludes its imread disk I/O, while the figure here
includes rendering the imagery on the same device.

Guards (a fast-but-wrong pipeline scores 0): tracking ATE_sim3 < 0.5
map-units over the ~320-unit route, and every device parity check
(`ya_vo_tpu.utils.parity`) passing. Without a GPU the bench refuses to
run; any phase that fails stops it with a non-zero exit.
"""

import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_T0 = time.perf_counter()


def _log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _ref_fps() -> float:
    path = os.path.join(_HERE, "native", "refbench", "BASELINE_MEASURED.json")
    with open(path) as f:
        return float(json.load(f)["ref_style_fps"])


def main():
    from ya_vo_tpu.utils import compile_cache, profiling

    _log(f"compile cache: {compile_cache.enable()}")
    profiling.require_gpu()
    import jax

    from ya_vo_tpu.ba.global_refine import global_refine
    from ya_vo_tpu.config import VOConfig
    from ya_vo_tpu.tracking.frontend import Frontend
    from ya_vo_tpu.utils import parity
    from ya_vo_tpu.utils.scene import TexturedSequence
    from ya_vo_tpu.viz import evaluation

    device = profiling.device_info()
    _log(f"device: {device}")

    N = 410
    WARM = 8
    REPS = max(1, int(os.environ.get("BENCH_REPS", "3")))
    seq = TexturedSequence(n_frames=N, seed=5)
    cfg = VOConfig()   # unmodified production defaults — reference gates
    gt_cw = np.linalg.inv(seq.poses[:N])

    # steady-state render throughput (dispatch 12, block once)
    seq.frame(0).block_until_ready()
    t0 = time.perf_counter()
    rend = [seq.frame(f) for f in range(1, 13)]
    jax.block_until_ready(rend)
    render_ms = (time.perf_counter() - t0) / 12 * 1e3

    fps_reps, ate_reps, resets_reps, discard_reps, compile_s = \
        [], [], [], [], []
    probe = {}
    for rep in range(REPS):
        _log(f"rep {rep}: warm-up and compile")
        fe = Frontend(cfg, seq.cam)
        t0 = time.perf_counter()
        for f in range(WARM):
            fe.process(np.asarray(jax.device_get(seq.frame(f))))
        fe.precompile()
        compile_s.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        fe.run((seq.frame(f) for f in range(WARM, N)), pipelined=True)
        jax.effects_barrier()
        dt = time.perf_counter() - t0
        fps_reps.append((N - WARM) / dt)
        ate = float(evaluation.ate_rmse(np.stack(fe.trajectory), gt_cw,
                                        with_scale=True))
        ate_reps.append(ate)
        resets_reps.append(fe.n_resets)
        discard_reps.append(fe.n_ba_discarded)
        _log(f"rep {rep}: {fps_reps[-1]:.2f} frames/s incl on-device "
             f"render ({dt:.1f} s / {N - WARM} frames), ate_sim3={ate:.4f},"
             f" resets={fe.n_resets}, ba_runs={fe.n_ba_runs}, "
             f"ba_discarded={fe.n_ba_discarded}")
        if rep == 0:
            probe = fe.device_throughput_probe(rend[:4], n_steps=200)
            _log(f"device step: {probe['device_step_ms']} ms")

    fps = float(np.median(fps_reps))
    ate_raw = float(np.median(ate_reps))
    ate_refined = float(evaluation.ate_rmse(global_refine(fe), gt_cw,
                                            with_scale=True))
    checks = parity.run(out=sys.stderr)
    parity_ok = all(r["ok"] for r in checks)

    ok = ate_raw < 0.5 and parity_ok
    out = {
        "metric": "vo_pipeline_fps_kitti_res_production",
        "value": round(fps if ok else 0.0, 3),
        "unit": "frames/s",
        "vs_baseline": round((fps if ok else 0.0) / _ref_fps(), 3),
        "reps": REPS,
        "fps_reps": [round(x, 2) for x in fps_reps],
        "timed_frames": N - WARM,
        "render_ms_per_frame": round(render_ms, 2),
        "ate_raw_m": round(ate_raw, 4),
        "ate_reps": [round(x, 4) for x in ate_reps],
        "ate_refined_m": round(ate_refined, 4),
        "resets_reps": resets_reps,
        "ba_discarded_reps": discard_reps,
        "warmup_compile_s_reps": [round(x, 1) for x in compile_s],
        "parity": "pass" if parity_ok else
        [r["check"] for r in checks if not r["ok"]],
        **probe,
        "device": device,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
