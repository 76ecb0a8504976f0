"""Device parity checks: what the accelerator computes against the repo's
own references, at the production frame size (376x1241, 2,048 keypoints).

The CPU tests cover the same maths at small sizes; these checks run on the
device the program is deployed on, so a compiler or precision difference
there cannot ship unseen. Each check states its tolerance and its reason:

  * renderer vs a float64 numpy ray caster: at most 0.5% of pixels off by
    more than 8 grey levels (a ray that grazes a quad edge may hit the
    neighbouring quad by one ULP of difference);
  * FAST segment-test corner mask vs the same function on the host CPU:
    exact (integer-valued comparisons of uint8 intensities);
  * BRIEF descriptors: bit-exact across two device runs;
  * Hamming matrix vs numpy popcount over all 2,048 x 2,048 pairs: exact
    (int8 +-1 products accumulated in int32);
  * on a GPU, the LK kernel (`lk_gpu.track`) vs XLA's `lk.track` on the
    same device: status agreement and p95 position disagreement within
    the bounds below. On an H100 the two agreed exactly (all 2,048
    statuses, 0.0 px); the bounds leave room for a different summation
    order, where a track at the freeze threshold `eps` can stop one step
    apart.

`run()` returns one record per check; callers fail when any is not ok.
"""

from __future__ import annotations

import json
import sys

import numpy as np

# LK kernel vs lk.track, on the H100 at the production shapes
LK_MIN_STATUS_AGREEMENT = 0.999
LK_MAX_P95_PX = 0.01


def _frames(seed: int = 5):
    import jax

    from ya_vo_tpu.utils.scene import TexturedSequence

    seq = TexturedSequence(n_frames=3, seed=seed, noise_sigma=0.0)
    img0 = np.asarray(jax.device_get(seq.frame(0)))
    img1 = np.asarray(jax.device_get(seq.frame(1)))
    return seq, img0, img1


def raycast_reference(seq, f: int = 0) -> np.ndarray:
    """Frame `f` of a TexturedSequence (noise-free), ray-cast in float64
    numpy: the plain reference for `scene.render_frame`."""
    from ya_vo_tpu.utils import scene

    culled = scene.cull_quads(seq.quads, seq.poses[f], seq.q_max)
    K_inv = np.asarray(seq.K_inv, np.float64)
    pose = seq.poses[f].astype(np.float64)
    H, W = seq.height, seq.width
    R, t = pose[:3, :3], pose[:3, 3]
    cw = -R.T @ t
    vv, uu = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    d_cam = np.stack([uu, vv, np.ones_like(uu)], -1) @ K_inv.T
    d_w = d_cam @ R

    bt = np.full((H, W), 1e9)
    ba = np.zeros((H, W)); bb = np.zeros((H, W))
    brect = np.zeros((H, W, 4)); bden = np.zeros((H, W))
    for q in range(len(culled.origin)):
        if not culled.valid[q]:
            continue
        o = culled.origin[q].astype(np.float64)
        v1 = culled.e1[q].astype(np.float64)
        v2 = culled.e2[q].astype(np.float64)
        rect = culled.atlas[q].astype(np.float64)
        n = np.cross(v1, v2)
        denom = d_w @ n
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        tt = np.dot(o - cw, n) / denom
        p = cw + tt[..., None] * d_w
        rel = p - o
        a = (rel @ v1) / max(v1 @ v1, 1e-9)
        b = (rel @ v2) / max(v2 @ v2, 1e-9)
        z = tt * d_cam[..., 2]
        good = ((z > 0.2) & (tt < bt) & (a >= 0) & (a <= 1)
                & (b >= 0) & (b <= 1))
        bt = np.where(good, tt, bt)
        ba = np.where(good, a, ba); bb = np.where(good, b, bb)
        brect = np.where(good[..., None], rect, brect)
        bden = np.where(good, rect[2] / np.sqrt(max(v1 @ v1, 1e-9)), bden)
    hit = bt < 5e8

    mips = [np.asarray(m, np.float64) for m in seq.mips]
    tu = brect[..., 0] + ba * brect[..., 2]
    tv = brect[..., 1] + bb * brect[..., 3]
    fx_eff = 1.0 / K_inv[0, 0]
    lod = np.log2(np.maximum(bt * bden / fx_eff, 1e-6))
    lod = np.clip(lod, 0.0, len(mips) - 1.001)
    val = np.zeros((H, W))
    for li, tex in enumerate(mips):
        S0, S1 = tex.shape
        u = np.clip(tu * 0.5 ** li, 0, S1 - 1.001)
        v = np.clip(tv * 0.5 ** li, 0, S0 - 1.001)
        u0 = np.floor(u).astype(int); v0 = np.floor(v).astype(int)
        fu, fv = u - u0, v - v0
        s = (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
             + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)
        val += np.clip(1.0 - np.abs(lod - li), 0, 1) * s
    elev = d_cam[..., 1]
    sky = 205.0 + 28.0 * np.clip(elev, -1.0, 0.3)
    ref = np.where(hit, val, sky)
    cyy, cxx = (H - 1) / 2.0, (W - 1) / 2.0
    r2 = (((np.arange(H) - cyy) / cyy)[:, None] ** 2
          + ((np.arange(W) - cxx) / cxx)[None, :] ** 2)
    return np.clip(ref * (1.0 - 0.18 * r2 / 2.0), 0, 255)


def check_renderer(seq, img0) -> dict:
    diff = np.abs(raycast_reference(seq) - img0.astype(np.float64))
    frac_big = float((diff > 8).mean())
    return dict(check="renderer", ok=frac_big < 0.005,
                mean_abs=float(diff.mean()), frac_gt8=frac_big)


def check_fast(img0, threshold: float, arc: int) -> dict:
    import jax
    import jax.numpy as jnp

    from ya_vo_tpu.features import fast

    resp = jax.jit(fast.fast_response, static_argnums=(1, 2))
    dev = np.asarray(resp(jnp.asarray(img0, jnp.float32), threshold, arc))
    with jax.default_device(jax.devices("cpu")[0]):
        host = np.asarray(resp(jnp.asarray(img0, jnp.float32), threshold,
                               arc))
    b = 3   # the ring wraps around the border; only the interior is a test
    n_diff = int((dev[b:-b, b:-b] != host[b:-b, b:-b]).sum())
    return dict(check="fast_corner_mask", ok=n_diff == 0,
                n_corners=int(host[b:-b, b:-b].sum()), n_diff=n_diff)


def _extract(img0, border: int):
    import jax.numpy as jnp

    from ya_vo_tpu.config import VOConfig
    from ya_vo_tpu.features import brief, fast

    fc = VOConfig().features
    kp = fast.detect(jnp.asarray(img0), max_keypoints=fc.max_keypoints,
                     threshold=fc.fast_threshold,
                     arc_length=fc.fast_arc_length,
                     nms_radius=fc.nms_radius, border=border,
                     harris_k=fc.harris_k)
    offsets = brief.make_offsets(fc.brief_n_bits, fc.brief_patch_radius,
                                 fc.brief_seed)
    blur = brief.gaussian_blur(jnp.asarray(img0, jnp.float32),
                               fc.blur_ksize, fc.blur_sigma)
    return kp, blur, offsets


def check_brief(img0):
    from ya_vo_tpu.features import brief

    kp, blur, offsets = _extract(img0, border=16)
    d1, _ = brief.describe(blur, kp.uv, kp.mask, offsets)
    d2, _ = brief.describe(blur, kp.uv, kp.mask, offsets)
    same = bool((np.asarray(d1) == np.asarray(d2)).all())
    rec = dict(check="brief_determinism", ok=same, n_desc=int(kp.count()))
    return rec, np.asarray(d1), np.asarray(kp.mask)


def popcount_hamming(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """[K1, K2] Hamming distances of packed uint32 descriptors (numpy,
    a byte popcount table, 128 rows at a time)."""
    table = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(1).astype(np.int32)
    b2 = np.ascontiguousarray(d2).view(np.uint8)
    out = np.empty((d1.shape[0], d2.shape[0]), np.int32)
    for i in range(0, d1.shape[0], 128):
        b1 = np.ascontiguousarray(d1[i:i + 128]).view(np.uint8)
        out[i:i + 128] = table[b1[:, None, :] ^ b2[None, :, :]].sum(-1)
    return out


def check_hamming(desc, mask) -> dict:
    import jax.numpy as jnp

    from ya_vo_tpu.features import matching

    # second set: the same descriptors rolled, so distances span 0..256
    desc2 = np.roll(desc, 1, axis=0)
    mask2 = np.roll(mask, 1)
    got = np.asarray(matching.hamming_matrix(
        jnp.asarray(desc), jnp.asarray(desc2), jnp.asarray(mask),
        jnp.asarray(mask2)))
    ref = np.where(mask[:, None] & mask2[None, :],
                   popcount_hamming(desc, desc2), matching.INVALID_DIST)
    n_diff = int((got != ref).sum())
    return dict(check="hamming_matrix", ok=n_diff == 0,
                shape=list(got.shape), n_diff=n_diff)


def compare_lk(a, b, mask) -> dict:
    """Status agreement and position disagreement of two FlowResults."""
    sa, sb = np.asarray(a.status), np.asarray(b.status)
    both = sa & sb
    d = np.linalg.norm(np.asarray(a.uv)[both] - np.asarray(b.uv)[both],
                       axis=1)
    n = int(np.asarray(mask).sum())
    return dict(
        n_tracks=n, n_status_a=int(sa.sum()), n_status_b=int(sb.sum()),
        status_agreement=float((sa == sb)[np.asarray(mask)].mean()),
        median_px=float(np.median(d)) if len(d) else 0.0,
        p95_px=float(np.percentile(d, 95)) if len(d) else 0.0,
        max_px=float(d.max()) if len(d) else 0.0)


def check_lk(img0, img1) -> dict:
    import jax.numpy as jnp

    from ya_vo_tpu.tracking import lk, lk_gpu

    kp, _, _ = _extract(img0, border=24)
    a = jnp.asarray(img0, jnp.float32)
    b = jnp.asarray(img1, jnp.float32)
    ref = lk.track(a, b, kp.uv, kp.uv, kp.mask)
    got = lk_gpu.track(a, b, kp.uv, kp.uv, kp.mask)
    rec = compare_lk(ref, got, kp.mask)
    ok = (rec["status_agreement"] >= LK_MIN_STATUS_AGREEMENT
          and rec["p95_px"] <= LK_MAX_P95_PX and rec["n_status_a"] > 0)
    return dict(check="lk_gpu_vs_lk_track", ok=ok, **rec)


def run(out=sys.stdout) -> list:
    """Run every check on the default device; one JSON line each to
    `out`. Returns the records."""
    import jax

    from ya_vo_tpu.config import VOConfig

    fc = VOConfig().features
    seq, img0, img1 = _frames()
    recs = [check_renderer(seq, img0),
            check_fast(img0, float(fc.fast_threshold), fc.fast_arc_length)]
    rec, desc, mask = check_brief(img0)
    recs += [rec, check_hamming(desc, mask)]
    if jax.default_backend() == "gpu":
        recs.append(check_lk(img0, img1))
    for r in recs:
        print(json.dumps(r), file=out, flush=True)
    return recs
