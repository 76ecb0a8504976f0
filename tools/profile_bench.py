"""Per-frame host wall-time breakdown of the pipelined driver
(dispatch, resolve, window BA) on the stamps-world corridor route."""
import os
import sys
import time
import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ya_vo_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

from ya_vo_tpu.tracking.frontend import Frontend
from ya_vo_tpu.config import VOConfig, TrackConfig, FeatureConfig, BAConfig
from ya_vo_tpu.utils import synthetic

H, W = 376, 1241
n_frames = 40
imgs, poses_gt, lms, cam = synthetic.render_sequence(
    n_frames=n_frames, n_landmarks=1200, height=H, width=W,
    step=0.5, yaw_rate=0.002, seed=11, corridor=True)

cfg = VOConfig(image_height=H, image_width=W,
               features=FeatureConfig(max_keypoints=2048),
               tracking=TrackConfig(min_ba_inliers=20, min_flow_inliers=5),
               ba=BAConfig(asynchronous=True))
fe = Frontend(cfg, cam)
warm = 6
for img in imgs[:warm]:
    fe.process(img)

# monkeypatch-time the inner phases
phase = {"dispatch": [], "finish": [], "ba": [], "buildprob": []}
for name, key in [("_dispatch_track", "dispatch"), ("_finish_track", "finish"),
                  ("_run_window_ba", "ba"), ("_build_window_problem",
                                             "buildprob")]:
    orig = getattr(fe, name)
    def make(orig, key):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            phase[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrap
    setattr(fe, name, make(orig, key))

# mimic fe.run's pipelined loop but time each _pipe_step call
frames = imgs[warm:]
it = iter(frames)
pending = jax.device_put(np.asarray(next(it)))
times = []
kf_flags = []
while pending is not None:
    nxt = next(it, None)
    t0 = time.perf_counter()
    nbefore = len(fe._pipe_queue) if hasattr(fe, "_pipe_queue") else 0
    fe._pipe_step(pending)
    dt = time.perf_counter() - t0
    times.append(dt * 1e3)
    pending = jax.device_put(np.asarray(nxt)) if nxt is not None else None
t0 = time.perf_counter()
fe._pipe_flush()
flush_ms = (time.perf_counter() - t0) * 1e3
fe.finish()

times = np.array(times)
print(f"frames={len(times)} total={times.sum()+flush_ms:.1f} ms "
      f"flush={flush_ms:.1f} ms")
print(f"mean={times.mean():.1f} median={np.median(times):.1f} "
      f"p90={np.percentile(times,90):.1f} max={times.max():.1f}")
print("per-frame ms:", np.round(times, 1).tolist())
# keyframe count from the map
print("keyframes:", fe.map.n_keyframes, "landmarks:", fe.map.n_landmarks)
for k, v in phase.items():
    if v:
        v = np.array(v)
        print(f"{k}: n={len(v)} mean={v.mean():.1f} sum={v.sum():.0f} "
              f"max={v.max():.1f}")
