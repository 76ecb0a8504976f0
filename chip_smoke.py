"""Smoke test of the VO main path on a GPU: the quickest proof that the
system still starts, computes the right thing and runs at its real size.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # the distributed window BA, 4 GPUs

One GPU, at the production config (`VOConfig()`: 376x1241 frames, 2,048
keypoints, window 8, 4,096 BA landmarks) on the seeded
`TexturedSequence(seed=5)` route bench.py uses. Phases, each fatal:

  1. device: JAX's default backend must be a GPU;
  2. parity: `utils.parity.run()` (renderer, FAST, BRIEF, Hamming and the
     LK kernel against their references, at the production frame size);
  3. GPU tests: the `gpu`-marked tests, compiled for the card;
  4. end to end: `Frontend.run(pipelined=True)` over a 130-frame route
     (8 warm-up frames, then `precompile()`), long enough for several
     window-BA solves; fails on non-finite poses, no BA solve, or
     ATE_sim3 >= 0.5 (bench.py's guard);
  5. CLI: `run_vo.main(["--synthetic", ...])` in-process.

`--four-cards` runs only the distributed path and what it is compared
with: the same route with `BAConfig.distributed="auto"` over 4 GPUs
against "off" on one; one production window (W=8, L=4,096) solved by the
sharded solver and by `ba.window.solve_window`; ms per GN iteration on 1
and 4 GPUs beside the exact collective bytes.

Results go to stdout, one line each; the last line is the JSON verdict
{"ok": true, "device": {"platform", "kind", "count"}}. Any failure raises,
so the exit code is non-zero and no verdict is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

N_FRAMES = 130
WARM = 8
SEED = 5


def _say(**rec) -> None:
    print(json.dumps(rec), flush=True)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {what}")


def run_route(cfg) -> dict:
    """The main path: bootstrap, precompile, pipelined run; returns the
    route's metrics."""
    import jax

    from ya_vo_tpu.tracking.frontend import Frontend
    from ya_vo_tpu.utils.scene import TexturedSequence
    from ya_vo_tpu.viz import evaluation

    n_frames = N_FRAMES
    seq = TexturedSequence(n_frames=n_frames, seed=SEED)
    fe = Frontend(cfg, seq.cam)
    t0 = time.perf_counter()
    for f in range(WARM):
        fe.process(np.asarray(jax.device_get(seq.frame(f))))
    fe.precompile()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    traj = fe.run((seq.frame(f) for f in range(WARM, n_frames)),
                  pipelined=True)
    jax.effects_barrier()
    dt = time.perf_counter() - t0
    gt_cw = np.linalg.inv(seq.poses[:n_frames])
    rec = dict(frames=len(traj), fps=(n_frames - WARM) / dt,
               warmup_and_compile_s=warm_s,
               ate_sim3=float(evaluation.ate_rmse(traj, gt_cw,
                                                  with_scale=True)),
               resets=fe.n_resets, n_ba_runs=fe.n_ba_runs,
               n_ba_discarded=fe.n_ba_discarded,
               finite=bool(np.isfinite(traj).all()),
               sharded_ba=fe._dist_ba is not None)
    if fe.status.name == "TRACKING":
        rec.update(fe.device_throughput_probe(
            [seq.frame(f) for f in range(1, 5)], n_steps=200))
    return rec


def phase_parity() -> None:
    from ya_vo_tpu.utils import parity

    recs = parity.run()
    failed = [r["check"] for r in recs if not r["ok"]]
    _check(not failed, f"parity checks {failed}")


class _Passes:
    """pytest plugin: counts the tests that ran and passed."""

    def __init__(self):
        self.n = 0

    def pytest_runtest_logreport(self, report):
        self.n += report.when == "call" and report.passed


def phase_gpu_tests() -> None:
    import pytest

    passes = _Passes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(_HERE, "tests", "test_lk_gpu.py")],
                     plugins=[passes])
    _say(phase="gpu_tests", exit_code=int(rc), passed=passes.n)
    _check(rc == 0 and passes.n > 0, "gpu-marked tests did not all pass")


def phase_end_to_end() -> None:
    from ya_vo_tpu.config import VOConfig

    rec = run_route(VOConfig())
    _say(phase="end_to_end", **rec)
    _check(rec["finite"], "non-finite poses")
    _check(rec["n_ba_runs"] > 0, "no window-BA solve ran")
    _check(rec["ate_sim3"] < 0.5, f"ATE_sim3 {rec['ate_sim3']:.4f} >= 0.5")


def phase_cli() -> None:
    import run_vo

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_vo.main(["--synthetic", "--synthetic-frames", "30"])
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    _say(phase="cli", rc=rc, **summary)
    _check(rc == 0 and summary["frames"] == 30, "run_vo --synthetic")
    _check(bool(np.isfinite(summary["ate_sim3_m"])), "run_vo ATE")


def four_cards() -> None:
    import jax

    from ya_vo_tpu.ba import window
    from ya_vo_tpu.config import VOConfig
    from ya_vo_tpu.parallel import dist_ba, mesh as mesh_lib, scaling_bench
    from ya_vo_tpu.utils import synthetic

    _check(len(jax.devices()) == 4, f"{len(jax.devices())} GPUs, need 4")
    base = VOConfig()
    routes = {}
    for mode in ("auto", "off"):
        cfg = dataclasses.replace(
            base, ba=dataclasses.replace(base.ba, distributed=mode))
        routes[mode] = run_route(cfg)
        _say(phase="route", ba_distributed=mode, **routes[mode])
        _check(routes[mode]["finite"] and routes[mode]["n_ba_runs"] > 0,
               f"route with distributed={mode}")
    _check(routes["auto"]["sharded_ba"], "4 GPUs but the BA was not sharded")
    _say(phase="route_compare",
         ate_4_cards=routes["auto"]["ate_sim3"],
         ate_1_card=routes["off"]["ate_sim3"],
         ate_diff=routes["auto"]["ate_sim3"] - routes["off"]["ate_sim3"])
    _check(routes["auto"]["ate_sim3"] < 0.5, "4-card route ATE >= 0.5")

    # one production window: sharded solver vs the single-device solver
    bc = base.ba
    W, L = base.map.window_size, bc.max_window_landmarks
    prob, cam, _, _ = synthetic.window_problem(
        W=W, L=L, O=base.features.max_keypoints)
    kw = dict(iters=bc.iters, huber_delta=bc.huber_delta,
              damping=bc.damping, n_fixed_poses=2,
              pose_prior_weight=bc.pose_prior_weight)
    single = window.solve_window(prob, cam, **kw)
    solve = dist_ba.make_dist_solver(mesh_lib.landmark_mesh(4), cam, **kw)
    poses_d, _, c0, c1 = solve(dist_ba.from_window_problem(prob))
    diff = float(np.abs(np.asarray(poses_d)
                        - np.asarray(single.poses)).max())
    # atol 2e-2: the free monocular scale gauge (tests/test_dist_ba.py)
    _say(phase="window_solve", W=W, L=L, max_abs_pose_diff=diff,
         cost0=float(c0), cost1=float(c1))
    _check(diff < 2e-2, f"sharded vs single window solve differ by {diff}")

    for row in scaling_bench.measure(L=L, W=W, iters=4,
                                     device_counts=[1, 4]):
        _say(phase="gn_iter", **row, collective_bytes=dist_ba
             .collective_bytes_per_iter(W, L, 1, row["devices"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU distributed window BA path")
    args = ap.parse_args(argv)

    from ya_vo_tpu.utils import compile_cache, profiling

    compile_cache.enable()
    profiling.require_gpu()
    info = profiling.device_info()
    _say(phase="device", **info)
    print(profiling.gpu_name_and_power_limit(), flush=True)

    if args.four_cards:
        four_cards()
    else:
        phase_parity()
        phase_gpu_tests()
        phase_end_to_end()
        phase_cli()

    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["device_kind"],
        "count": info["device_count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
