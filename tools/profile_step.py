"""Device times of the fused tracking step and its layers, on a GPU.

Usage: python tools/profile_step.py [--frames N] [--out PATH]

At the production config (`VOConfig()`, 376x1241, 2,048 keypoints) on the
seeded `TexturedSequence(seed=5)` route bench.py uses, this prints one JSON
line per measurement:

  * plain-XLA device times of FAST+Harris+NMS (`fast.detect`), the
    2,048 x 2,048 Hamming matrix, BRIEF, and LK (`lk.track`);
  * the Triton LK kernel (`lk_gpu.track`) at several block shapes, and its
    disagreement with `lk.track` on the same frame pair;
  * the LK decision itself: the whole pipeline run with `lk.track` and with
    `lk_gpu.track` inside the fused step, in the order XLA, kernel, kernel,
    XLA, each giving end-to-end frames/s, ATE and the device step time
    (`Frontend.device_throughput_probe`).

Every line names the card; the last line is the combined record, also
written to `--out` (default chiprun_out/profile_step.json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def device_ms(fn, n: int = 50) -> float:
    """Median of `n` back-to-back calls, each ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def layer_times(seq, emit) -> bool:
    """Per-layer device times; returns whether the LK kernel compiled."""
    import jax
    import jax.numpy as jnp

    from ya_vo_tpu.config import VOConfig
    from ya_vo_tpu.features import brief, fast, matching
    from ya_vo_tpu.tracking import lk, lk_gpu
    from ya_vo_tpu.utils import parity

    cfg = VOConfig()
    fc, tc = cfg.features, cfg.tracking
    img0, img1 = seq.frame(0), seq.frame(1)
    detect = jax.jit(lambda im: fast.detect(
        im, max_keypoints=fc.max_keypoints, threshold=fc.fast_threshold,
        arc_length=fc.fast_arc_length, nms_radius=fc.nms_radius,
        border=fc.brief_patch_radius + fc.blur_ksize // 2 + 4,
        harris_k=fc.harris_k))
    kp = detect(img0)
    emit(layer="fast_detect", ms=device_ms(lambda: detect(img1)))

    offsets = brief.make_offsets(fc.brief_n_bits, fc.brief_patch_radius,
                                 fc.brief_seed)
    describe = jax.jit(lambda im, kp: brief.describe(brief.gaussian_blur(
        im.astype(jnp.float32), fc.blur_ksize, fc.blur_sigma),
        kp.uv, kp.mask, offsets)[0])
    desc = describe(img0, kp)
    emit(layer="blur_brief", ms=device_ms(lambda: describe(img0, kp)))

    desc2 = jnp.roll(desc, 1, axis=0)
    ham = jax.jit(matching.hamming_matrix)
    emit(layer="hamming_matrix", shape=[int(desc.shape[0])] * 2,
         ms=device_ms(lambda: ham(desc, desc2, kp.mask, kp.mask)))

    a = img0.astype(jnp.float32)
    b = img1.astype(jnp.float32)
    kw = dict(levels=tc.lk_levels, half=tc.lk_window // 2,
              iters=tc.lk_iters, eps=tc.lk_eps)
    ref = lk.track(a, b, kp.uv, kp.uv, kp.mask, **kw)
    emit(layer="lk_track_xla",
         ms=device_ms(lambda: lk.track(a, b, kp.uv, kp.uv, kp.mask, **kw)))
    best = None
    for bt, nw in ((16, 4), (32, 4), (32, 8), (64, 4), (64, 8), (128, 8)):
        lk_gpu.BLOCK_TRACKS, lk_gpu.NUM_WARPS = bt, nw
        fn = jax.jit(lk_gpu.track.__wrapped__, static_argnames=tuple(kw))
        try:
            t0 = time.perf_counter()
            got = jax.block_until_ready(fn(a, b, kp.uv, kp.uv, kp.mask, **kw))
            compile_s = time.perf_counter() - t0
            ms = device_ms(lambda: fn(a, b, kp.uv, kp.uv, kp.mask, **kw))
        except Exception as e:  # a block shape the card refuses: report it
            emit(layer="lk_gpu", block_tracks=bt, num_warps=nw,
                 error=f"{type(e).__name__}: {str(e)[:300]}")
            continue
        emit(layer="lk_gpu", block_tracks=bt, num_warps=nw, ms=ms,
             first_call_s=compile_s, **parity.compare_lk(ref, got, kp.mask))
        if best is None or ms < best[0]:
            best = (ms, bt, nw)
    if best is None:
        return False
    # the pipeline A/B below runs the fastest block shape
    lk_gpu.BLOCK_TRACKS, lk_gpu.NUM_WARPS = best[1:]
    emit(layer="lk_gpu_choice", block_tracks=best[1], num_warps=best[2])
    return True


def pipeline_ab(seq, n_frames: int, emit, order=("xla", "kernel", "kernel",
                                                   "xla")) -> None:
    """End-to-end A/B of the LK implementation inside the fused step."""
    import jax

    from ya_vo_tpu.config import VOConfig
    from ya_vo_tpu.tracking import lk, lk_gpu
    from ya_vo_tpu.tracking.frontend import Frontend
    from ya_vo_tpu.viz import evaluation

    impl = {"xla": lk.track, "kernel": lk_gpu.track}
    warm = 8
    gt_cw = np.linalg.inv(seq.poses[:n_frames])
    probe_imgs = [seq.frame(f) for f in range(1, 5)]
    for variant in order:
        lk.auto_track = impl[variant]
        fe = Frontend(VOConfig(), seq.cam)
        t0 = time.perf_counter()
        for f in range(warm):
            fe.process(np.asarray(jax.device_get(seq.frame(f))))
        fe.precompile()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fe.run((seq.frame(f) for f in range(warm, n_frames)), pipelined=True)
        jax.effects_barrier()
        dt = time.perf_counter() - t0
        ate = float(evaluation.ate_rmse(np.stack(fe.trajectory), gt_cw,
                                        with_scale=True))
        rec = dict(ab=variant, fps=(n_frames - warm) / dt, ate_sim3=ate,
                   resets=fe.n_resets, n_ba_runs=fe.n_ba_runs,
                   n_ba_discarded=fe.n_ba_discarded, warmup_compile_s=warm_s)
        if fe.status.name == "TRACKING":
            rec.update(fe.device_throughput_probe(probe_imgs, n_steps=200))
        emit(**rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=130)
    ap.add_argument("--out", default="chiprun_out/profile_step.json")
    args = ap.parse_args(argv)

    from ya_vo_tpu.utils import compile_cache, profiling

    compile_cache.enable()
    profiling.require_gpu()
    from ya_vo_tpu.utils.scene import TexturedSequence

    dev = profiling.device_info()
    print(dev["gpu_name"] + ", " + dev["power_limit"], flush=True)
    records = []

    def emit(**rec):
        rec["device_kind"] = dev["device_kind"]
        rec["power_limit"] = dev["power_limit"]
        records.append(rec)
        print(json.dumps(rec), flush=True)

    seq = TexturedSequence(n_frames=args.frames, seed=5)
    if layer_times(seq, emit):
        pipeline_ab(seq, args.frames, emit)
    else:
        pipeline_ab(seq, args.frames, emit, order=("xla",))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": dev, "records": records}, f, indent=1)
    print(json.dumps({"device": dev, "n_records": len(records)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
