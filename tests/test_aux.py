"""Auxiliary subsystems: checkpoint/resume continuity, KITTI trajectory
export/load roundtrip, rendering smoke, prefetch iterator, CLI runner."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ya_vo_tpu.io import kitti
from ya_vo_tpu.io.prefetch import PrefetchIterator
from ya_vo_tpu.utils import checkpoint as ckpt
from ya_vo_tpu.utils import synthetic
from ya_vo_tpu.viz import evaluation, render
from tests.test_frontend_e2e import make_config


def test_checkpoint_resume_continues_tracking(tmp_path):
    from ya_vo_tpu.tracking.frontend import Frontend

    imgs, poses_gt, lms, cam = synthetic.render_sequence(
        n_frames=10, n_landmarks=500, height=256, width=768,
        step=0.4, yaw_rate=0.004, seed=7)
    cfg = make_config(sync_ba=True)

    # run 6 frames, checkpoint, resume in a FRESH frontend, run the rest
    fe1 = Frontend(cfg, cam)
    for img in imgs[:6]:
        fe1.process(img)
    path = str(tmp_path / "state.npz")
    ckpt.save_frontend(fe1, path)

    fe2 = Frontend(cfg, cam)
    ckpt.load_frontend(fe2, path)
    assert fe2.frame_id == fe1.frame_id
    for img in imgs[6:]:
        fe2.process(img)

    # reference run without interruption
    fe_ref = Frontend(cfg, cam)
    fe_ref.run(imgs)

    traj2 = np.stack(fe2.trajectory)
    gt_cw = np.linalg.inv(poses_gt)
    ate_resumed = evaluation.ate_rmse(traj2, gt_cw)
    ate_ref = evaluation.ate_rmse(np.stack(fe_ref.trajectory), gt_cw)
    assert fe2.n_resets == 0
    assert ate_resumed < max(0.05, 2 * ate_ref), (ate_resumed, ate_ref)


def test_checkpoint_persists_window_barrier(tmp_path):
    """The scale-break fence survives save/load: a resumed session must not
    solve a BA window straddling a pre-checkpoint bootstrap reset
    (round-3 advisor, low)."""
    from ya_vo_tpu.tracking.frontend import Frontend

    imgs, poses_gt, lms, cam = synthetic.render_sequence(
        n_frames=6, n_landmarks=400, height=256, width=768,
        step=0.4, yaw_rate=0.004, seed=9)
    cfg = make_config(sync_ba=True)
    fe1 = Frontend(cfg, cam)
    for img in imgs:
        fe1.process(img)
    fe1.map.mark_scale_break()      # simulate a mid-sequence bootstrap reset
    barrier = fe1.map.window_barrier
    assert barrier > 0
    path = str(tmp_path / "state.npz")
    ckpt.save_frontend(fe1, path)

    fe2 = Frontend(cfg, cam)
    ckpt.load_frontend(fe2, path)
    assert fe2.map.window_barrier == barrier


def test_trajectory_kitti_roundtrip(tmp_path):
    poses_wc = synthetic.forward_trajectory(20, step=0.7, yaw_rate=0.01)
    cam_to_world = np.linalg.inv(poses_wc)
    path = str(tmp_path / "poses.txt")
    kitti.save_trajectory_kitti(path, cam_to_world)
    rows = np.loadtxt(path)
    assert rows.shape == (20, 12)
    back = rows.reshape(-1, 3, 4)
    np.testing.assert_allclose(back, cam_to_world[:, :3, :4], atol=1e-6)


def test_gt_pose_loader(tmp_path):
    os.makedirs(tmp_path / "poses", exist_ok=True)
    poses = np.linalg.inv(synthetic.forward_trajectory(5))
    np.savetxt(tmp_path / "poses" / "07.txt",
               poses[:, :3, :4].reshape(-1, 12))
    out = kitti.load_gt_poses(str(tmp_path), "07")
    assert out.shape == (5, 4, 4)
    np.testing.assert_allclose(out[:, :3, :4], poses[:, :3, :4], atol=1e-8)
    np.testing.assert_allclose(out[:, 3], np.tile([0, 0, 0, 1], (5, 1)))
    assert kitti.load_gt_poses(str(tmp_path), "99") is None


def test_render_outputs(tmp_path):
    est = synthetic.forward_trajectory(15, step=0.5)
    gt = np.linalg.inv(est)
    lms = synthetic.random_landmarks(100)
    p1 = render.plot_trajectory(est, gt, lms, str(tmp_path / "t.png"))
    assert os.path.getsize(p1) > 1000
    img = synthetic.render_scene(lms, est[0], synthetic.kitti_camera(),
                                 256, 512)
    p2 = render.draw_keypoints(img, np.array([[100.0, 100.0]]),
                               str(tmp_path / "k.png"))
    assert os.path.getsize(p2) > 1000


def test_prefetch_iterator_order_and_errors():
    items = list(range(20))
    out = list(PrefetchIterator(items, lambda x: x * 2, depth=3))
    assert out == [x * 2 for x in items]

    def boom(x):
        if x == 3:
            raise RuntimeError("decode failed")
        return x

    it = PrefetchIterator(range(10), boom, depth=2)
    got = []
    with pytest.raises(RuntimeError):
        for v in it:
            got.append(v)
    assert got == [0, 1, 2]


def test_image_stream_npy(tmp_path):
    seq = tmp_path / "sequences" / "00" / "image_0"
    os.makedirs(seq)
    for i in range(3):
        np.save(seq / f"{i:06d}.npy",
                np.full((40, 60), i, np.uint8))
    stream = kitti.ImageStream(str(tmp_path), "00")
    frames = list(stream)
    assert len(frames) == 3
    assert frames[1].mean() == 1


def test_draw_matches_and_epilines(tmp_path, rng):
    img1 = rng.integers(0, 255, (120, 200), dtype=np.uint8)
    img2 = rng.integers(0, 255, (120, 200), dtype=np.uint8)
    uv1 = rng.uniform([10, 10], [190, 110], (20, 2)).astype(np.float32)
    uv2 = uv1 + rng.normal(0, 2, uv1.shape).astype(np.float32)
    p = render.draw_matches(img1, img2, uv1, uv2,
                            out_path=str(tmp_path / "m.png"))
    assert os.path.getsize(p) > 1000
    F = np.array([[0, -1e-5, 1e-2], [1e-5, 0, -1e-2], [-1e-2, 1e-2, 1.0]])
    p2 = render.draw_epipolar_lines(img1, img2, F, uv1[:8],
                                    out_path=str(tmp_path / "e.png"))
    assert os.path.getsize(p2) > 1000


def test_package_api():
    import ya_vo_tpu

    fe = ya_vo_tpu.create_frontend()
    assert fe.cfg.features.fast_threshold == 20  # round-3 default (see FeatureConfig)
    assert ya_vo_tpu.VOConfig().sequence == "00"


@pytest.mark.parametrize("name", ["KITTI.json", "KITTI_mock_test.json"])
def test_reference_config_files_load(name):
    """Every key of the repo's config files lands in the loaded VOConfig
    unchanged (no key silently dropped or renamed)."""
    import dataclasses
    import json
    import os

    from ya_vo_tpu.config import VOConfig

    path = os.path.join(os.path.dirname(__file__), "..", "configs", name)
    with open(path) as f:
        raw = json.load(f)
    got = dataclasses.asdict(VOConfig.from_json(path))
    for key, val in raw.items():
        if isinstance(val, dict):
            assert {k: got[key][k] for k in val} == val, key
        else:
            assert got[key] == val, key


def test_shipped_config_files_load():
    """The shipped configs (README entry point) must always load — this
    regressed once when MatchConfig.max_matches was retired but the JSONs
    still carried it (round-3 advisor, high)."""
    import os

    from ya_vo_tpu.config import VOConfig

    root = os.path.join(os.path.dirname(__file__), "..")
    cfg = VOConfig.from_json(os.path.join(root, "configs", "KITTI.json"))
    assert cfg.base_path == "/data/kitti"
    cfg2 = VOConfig.from_json(
        os.path.join(root, "configs", "KITTI_mock_test.json"))
    assert cfg2.ba.asynchronous is False  # deterministic for mock tests


def test_unknown_config_keys_warn_not_raise():
    """Older-schema configs with retired keys load with a warning instead of
    TypeError (forward compatibility across framework upgrades)."""
    import warnings

    from ya_vo_tpu.config import VOConfig

    raw = {"matching": {"abs_threshold": 25, "max_matches": 1024},
           "tracking": {"min_ba_inliers": 50}}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg = VOConfig.from_dict(raw)
    assert cfg.matching.abs_threshold == 25
    assert cfg.tracking.min_ba_inliers == 50
    assert any("max_matches" in str(x.message) for x in w)


def test_checkpoint_mid_pipeline_flushes_inflight(tmp_path):
    """Checkpointing while the pipelined ingest queue holds in-flight
    frames must flush them first (round-4 advisor, medium): without the
    flush, sync_host_state snapshots the dispatched device frontier's
    track_uv/track_valid against resolved-frontier track_lm/last_pose,
    and the resumed session associates slot coordinates with the wrong
    landmarks."""
    import dataclasses

    import jax.numpy as jnp

    from ya_vo_tpu.tracking.frontend import Frontend

    imgs, poses_gt, lms, cam = synthetic.render_sequence(
        n_frames=12, n_landmarks=500, height=256, width=768,
        step=0.4, yaw_rate=0.004, seed=7)
    cfg = make_config(sync_ba=True)
    cfg = dataclasses.replace(
        cfg, tracking=dataclasses.replace(cfg.tracking, pipeline_depth=8))

    fe1 = Frontend(cfg, cam)
    for img in imgs[:3]:
        fe1.process(img)          # bootstrap synchronously
    for img in imgs[3:8]:
        fe1._pipe_step(jnp.asarray(img))   # leave frames IN FLIGHT
    assert len(fe1._pending_q) > 0, "precondition: in-flight frames"
    path = str(tmp_path / "state.npz")
    ckpt.save_frontend(fe1, path)
    # the save flushed the pipeline: host trajectory covers every frame fed
    assert len(fe1._pending_q) == 0
    assert len(fe1.trajectory) == 8

    fe2 = Frontend(cfg, cam)
    ckpt.load_frontend(fe2, path)
    for img in imgs[8:]:
        fe2.process(img)

    fe_ref = Frontend(cfg, cam)
    fe_ref.run(imgs)
    gt_cw = np.linalg.inv(poses_gt)
    ate_resumed = evaluation.ate_rmse(np.stack(fe2.trajectory), gt_cw)
    ate_ref = evaluation.ate_rmse(np.stack(fe_ref.trajectory), gt_cw)
    assert fe2.n_resets == 0
    assert ate_resumed < max(0.05, 2 * ate_ref), (ate_resumed, ate_ref)
