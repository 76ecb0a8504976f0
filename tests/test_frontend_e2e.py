"""End-to-end pipeline test: synthetic rendered sequence through the full
INIT -> TRACKING state machine, ATE checked against ground truth. This is
the minimum end-to-end slice of SURVEY.md §7.3 (the reference's
buildInitMap + track loop) with real accuracy asserts."""

import dataclasses

import numpy as np
import pytest

from ya_vo_tpu.config import VOConfig, TrackConfig, FeatureConfig
from ya_vo_tpu.tracking.frontend import Frontend, VOStatus
from ya_vo_tpu.utils import synthetic
from ya_vo_tpu.viz import evaluation


def make_config(sync_ba: bool = False, apply_mode: str = "device"):
    """sync_ba=True pins backend BA to the synchronous path — required by
    the run-equality tests below (async BA applies results at thread-timing-
    dependent frames, so two runs are not bit-comparable). apply_mode
    "push" keeps BA applies bit-exact across drivers (the exactness tests
    use it); "device" is the production default — see BAConfig.apply_mode."""
    cfg = VOConfig(
        image_height=256, image_width=768,
        features=FeatureConfig(max_keypoints=1024),
        tracking=TrackConfig(min_ba_inliers=15, min_flow_inliers=5),
    )
    cfg = dataclasses.replace(
        cfg, ba=dataclasses.replace(
            cfg.ba, apply_mode=apply_mode,
            asynchronous=False if sync_ba else cfg.ba.asynchronous))
    return cfg


@pytest.fixture(scope="module")
def sequence():
    imgs, poses, lms, cam = synthetic.render_sequence(
        n_frames=10, n_landmarks=500, height=256, width=768,
        step=0.4, yaw_rate=0.004, seed=7,
    )
    return imgs, poses, lms, cam


def poses_cam_to_world(poses_wc):
    return np.linalg.inv(poses_wc)


def test_full_pipeline_tracks_sequence(sequence):
    imgs, poses_wc_gt, lms, cam = sequence
    fe = Frontend(make_config(), cam)
    traj = fe.run(imgs)

    assert fe.status == VOStatus.TRACKING
    assert fe.n_resets == 0, [r.status for r in fe.results]
    assert traj.shape == (10, 4, 4)

    # monocular scale is free: evaluate ATE after Sim(3) alignment
    gt_cw = poses_cam_to_world(poses_wc_gt)
    ate = evaluation.ate_rmse(traj, gt_cw, with_scale=True)
    # 10 frames, ~3.6 m travelled; demand cm-level agreement
    assert ate < 0.05, (ate, [r.n_ba_inliers for r in fe.results])

    # rotation accuracy via RPE
    rpe_t, rpe_r = evaluation.rpe(traj, gt_cw)
    assert rpe_r < 0.3, rpe_r


def test_pipeline_metrics_populated(sequence):
    imgs, *_ , cam = sequence
    fe = Frontend(make_config(), cam)
    fe.run(imgs[:4])
    r = fe.results
    assert r[0].status == "INIT"
    assert all(x.status == "TRACKING" for x in r[1:])
    assert all(x.n_keypoints > 50 for x in r)
    assert r[1].n_matches > 20            # init matches
    assert all(x.n_ba_inliers > 10 for x in r[2:])
    assert "frame" in r[1].timings_ms


def test_map_populated(sequence):
    imgs, _, lms, cam = sequence
    fe = Frontend(make_config(), cam)
    fe.run(imgs[:6])
    st = fe.map.stats()
    assert st["n_keyframes"] >= 2
    assert st["n_alive"] > 50
    # triangulated landmark positions should be near TRUE landmarks up to
    # the global monocular scale: compare depth-normalized directions
    pos, idx = fe.map.alive_landmarks()
    dirs = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    true_dirs = lms / np.linalg.norm(lms, axis=-1, keepdims=True)
    # each estimated direction should be close to SOME true landmark dir
    dots = dirs @ true_dirs.T
    best = dots.max(axis=1)
    assert np.median(best) > 0.9999, np.median(best)


def test_window_ba_runs_and_preserves_accuracy(sequence):
    imgs, poses_wc_gt, lms, cam = sequence
    cfg = make_config()
    fe = Frontend(cfg, cam)
    traj = fe.run(imgs)
    gt_cw = poses_cam_to_world(poses_wc_gt)
    ate = evaluation.ate_rmse(traj, gt_cw, with_scale=True)
    assert fe.n_ba_runs >= 1
    assert ate < 0.05, ate


def test_ba_disabled_still_works(sequence):
    imgs, poses_wc_gt, lms, cam = sequence
    cfg = make_config()
    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, enabled=False))
    fe = Frontend(cfg, cam)
    traj = fe.run(imgs)
    assert fe.n_ba_runs == 0
    ate = evaluation.ate_rmse(traj, poses_cam_to_world(poses_wc_gt))
    assert ate < 0.08, ate


def test_pipelined_matches_sync_exactly(sequence):
    """The pipelined driver (dispatch-ahead + deferred gate resolution +
    redo-on-state-change) must produce BIT-IDENTICAL results to the
    synchronous reference semantics — same trajectory, same keyframe
    cadence, same reset count. Uses BAConfig.apply_mode="push" (the
    bit-exact apply path; the "device" fast path reassociates the
    correction product and is covered by the allclose test below)."""
    imgs, *_, cam = sequence
    fe_sync = Frontend(make_config(sync_ba=True, apply_mode="push"), cam)
    traj_sync = fe_sync.run(imgs, pipelined=False)
    fe_pipe = Frontend(make_config(sync_ba=True, apply_mode="push"), cam)
    traj_pipe = fe_pipe.run(imgs, pipelined=True)
    np.testing.assert_array_equal(traj_sync, traj_pipe)
    assert [r.is_keyframe for r in fe_sync.results] == \
        [r.is_keyframe for r in fe_pipe.results]
    assert fe_sync.n_resets == fe_pipe.n_resets
    assert [r.n_ba_inliers for r in fe_sync.results] == \
        [r.n_ba_inliers for r in fe_pipe.results]


def test_device_apply_matches_push_apply(sequence):
    """The optional "device" BA-apply path (correction composed into the
    device chain in place, in-flight frames rotated at resolve) is a
    documented APPROXIMATION of the default "push" path: in-flight frames
    keep tracking against pre-refinement landmarks for up to an apply
    cycle (BAConfig.apply_mode). Pin its contract: identical FSM decisions
    and a trajectory within a small fraction of the per-frame step (0.4
    units here) of the exact path."""
    imgs, *_, cam = sequence
    fe_push = Frontend(make_config(sync_ba=True, apply_mode="push"), cam)
    traj_push = fe_push.run(imgs, pipelined=True)
    fe_dev = Frontend(make_config(sync_ba=True, apply_mode="device"), cam)
    traj_dev = fe_dev.run(imgs, pipelined=True)
    np.testing.assert_allclose(traj_dev, traj_push, atol=0.15)
    assert fe_dev.n_resets == fe_push.n_resets
    assert [r.is_keyframe for r in fe_dev.results] == \
        [r.is_keyframe for r in fe_push.results]


def test_pipelined_matches_sync_through_reset(sequence):
    """Same equivalence through a blackout-induced RESET: the pipelined
    redo path must reproduce the synchronous reset recovery."""
    imgs, *_, cam = sequence
    corrupted = list(imgs[:6]) + [np.zeros_like(imgs[0])] * 2 + list(imgs[6:])
    fe_sync = Frontend(make_config(sync_ba=True, apply_mode="push"), cam)
    traj_sync = fe_sync.run(corrupted, pipelined=False)
    fe_pipe = Frontend(make_config(sync_ba=True, apply_mode="push"), cam)
    traj_pipe = fe_pipe.run(corrupted, pipelined=True)
    np.testing.assert_array_equal(traj_sync, traj_pipe)
    assert fe_sync.n_resets == fe_pipe.n_resets
    assert [r.status for r in fe_sync.results] == \
        [r.status for r in fe_pipe.results]


def test_async_ba_matches_sync_within_tolerance(sequence):
    """The ASYNC backend option must deliver comparable accuracy to the
    synchronous path on a short easy sequence — the round-1 instability
    (late first apply after an in-sequence jit compile -> oversized
    correction) is fixed by init precompile + staleness discard +
    deferred re-solve. (Round 5 flipped the production default to
    synchronous — where solves span several keyframes, async applies land
    stale and cost real accuracy on long routes, BAConfig.asynchronous — so
    async is now pinned explicitly here.)"""
    import dataclasses

    imgs, poses_wc_gt, lms, cam = sequence
    base = make_config()
    fe_a = Frontend(dataclasses.replace(
        base, ba=dataclasses.replace(base.ba, asynchronous=True)), cam)
    assert fe_a.cfg.ba.asynchronous
    traj_a = fe_a.run(imgs)
    fe_a.finish()
    fe_s = Frontend(make_config(sync_ba=True), cam)
    traj_s = fe_s.run(imgs)

    gt_cw = poses_cam_to_world(poses_wc_gt)
    ate_a = evaluation.ate_rmse(traj_a, gt_cw, with_scale=True)
    ate_s = evaluation.ate_rmse(traj_s, gt_cw, with_scale=True)
    assert ate_a < max(2.0 * ate_s, 0.05), (ate_a, ate_s)
    # the deferred-relaunch machinery must not starve refinement
    assert fe_a.n_ba_runs >= 1
    assert fe_a.n_ba_discarded <= fe_a.n_ba_runs


def test_reset_recovery_on_blackout(sequence):
    """Blank frames mid-sequence must trip the failure gates (reference
    LoopHandler.cc:144/:151) and the FSM must re-initialize and resume
    TRACKING afterwards — the reference's reinitialize() semantics."""
    imgs, poses_wc_gt, lms, cam = sequence
    corrupted = list(imgs[:6]) \
        + [np.zeros_like(imgs[0])] * 2 \
        + list(imgs[6:])
    fe = Frontend(make_config(), cam)
    fe.run(corrupted)
    assert fe.n_resets >= 1
    statuses = [r.status for r in fe.results]
    assert "RESET" in statuses or "INIT" in statuses[6:]
    # recovered: the tail of the sequence tracks again
    assert statuses[-1] == "TRACKING", statuses[-4:]
    assert fe.results[-1].n_ba_inliers >= 15
