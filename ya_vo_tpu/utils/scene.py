"""Photoreal-ish textured world renderer for end-to-end VO validation.

The round-1 bench scene (`utils/synthetic.render_scene`) splats isolated
binary stamps at projected landmark positions — no perspective patch warp,
no occlusion, no illumination change, no repeated texture. This module
replaces it with a ray-cast textured-quad world so the full pipeline sees
imagery with the failure modes of a real driving camera (the reference's
entire input domain is KITTI street scenes, reference:
src/LoopHandler.cc:37-57, misc/kitti01.png):

  * true perspective warp: every pixel is an exact ray/plane intersection
    sampled from a texture atlas — patches deform with viewpoint exactly
    like real planar structure;
  * occlusion: near quads (billboards/poles) z-buffer over far ones, so
    tracks die and landmarks get occluded mid-sequence;
  * repeated/aliased texture: atlas rects are drawn from a finite texture,
    so distinct world surfaces share appearance (matching ambiguity);
  * illumination drift: slow per-frame gain/bias + vignette, plus sensor
    noise — descriptors and the LK photometric gate must tolerate it;
  * unbounded sequences: the world is generated procedurally along the
    trajectory, so 4,000+-frame runs (KITTI 00 is 4,541 frames) exercise
    map lifecycle, not just a 40-frame toy.

Rendering runs as one jitted `lax.scan` over quads (memory O(H*W), not
O(H*W*Q)) and runs on the accelerator (bench/long runs) and the CPU
(tests at reduced resolution). All geometry ground truth (camera trajectory) is
closed-form for ATE evaluation.

Conventions: world frame = first camera frame (x right, y DOWN, z
forward); poses are world->camera 4x4 like the rest of the package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ya_vo_tpu.core.camera import Camera
from ya_vo_tpu.utils.synthetic import kitti_camera

CAM_HEIGHT = 1.65          # KITTI gray camera height above road (m)


# --------------------------------------------------------------------------
# texture atlas
# --------------------------------------------------------------------------
def make_texture(size: int = 2048, seed: int = 0,
                 photo: Optional[np.ndarray] = None) -> np.ndarray:
    """[size, size] float32 texture in [0, 255].

    Multi-octave value noise (fractal detail at every scale so FAST finds
    corners at any viewing distance) + high-contrast speckle rectangles +
    one deliberately REPEATED pattern band (adjacent copies of the same
    patch: descriptor-matching ambiguity, like repeated windows on a real
    facade). If `photo` (a real grayscale image, uint8) is given, random
    crops of it are blended into the atlas so surfaces carry real
    photographic texture.
    """
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    amp = 1.0
    for cells in (8, 16, 32, 64, 128, 256, 512, 1024):
        if cells > size:
            break
        g = rng.normal(0.0, 1.0, (cells + 1, cells + 1)).astype(np.float32)
        # bilinear upsample grid to full size
        ys = np.linspace(0, cells, size, endpoint=False)
        xs = np.linspace(0, cells, size, endpoint=False)
        y0 = ys.astype(int); x0 = xs.astype(int)
        fy = (ys - y0)[:, None]; fx = (xs - x0)[None, :]
        up = (g[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
              + g[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
              + g[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
              + g[np.ix_(y0 + 1, x0 + 1)] * fy * fx)
        tex += amp * up
        amp *= 0.8            # slow decay: real surfaces are rough at
        #                       every scale; fast decay gave a blurry world
        #                       FAST found ~50 corners/frame in
    tex += 0.6 * rng.normal(0.0, 1.0, tex.shape).astype(np.float32)
    tex = (tex - tex.mean()) / (tex.std() + 1e-6)
    tex = 128.0 + 46.0 * tex

    # speckle rectangles: sharp high-contrast corners at the FAST scale
    # (gravel, windows, road markings, signage)
    n_speckle = (size * size) // 350
    ys = rng.integers(0, size - 8, n_speckle)
    xs = rng.integers(0, size - 8, n_speckle)
    hs = rng.integers(1, 7, n_speckle)
    ws = rng.integers(1, 7, n_speckle)
    vals = rng.uniform(10, 245, n_speckle).astype(np.float32)
    for y, x, h, w, v in zip(ys, xs, hs, ws, vals):
        tex[y:y + h, x:x + w] = v

    # repeated band: the SAME 48x48 patch tiled 12x in one strip — a
    # realistic picket-fence/facade-window ambiguity. (A full-atlas-width
    # band made ~30% of the visible ground identical tiles; LK then locks
    # onto the wrong copy en masse — photometrically perfect, so only the
    # pose solve can reject it — and the inlier gate trips. Real repeated
    # texture exists at THIS scale, not that one.)
    patch = tex[:48, :48].copy()
    row = size - 64
    for x in range(0, min(12 * 48, size - 48), 48):
        tex[row:row + 48, x:x + 48] = patch

    if photo is not None:
        ph = np.asarray(photo, np.float32)
        for _ in range(12):
            ch = int(min(ph.shape[0], rng.integers(128, 256)))
            cw = int(min(ph.shape[1], rng.integers(128, 384)))
            sy = rng.integers(0, ph.shape[0] - ch + 1)
            sx = rng.integers(0, ph.shape[1] - cw + 1)
            dy = rng.integers(0, size - ch)
            dx = rng.integers(0, size - cw)
            tex[dy:dy + ch, dx:dx + cw] = ph[sy:sy + ch, sx:sx + cw]

    return np.clip(tex, 2.0, 253.0).astype(np.float32)


def _mip_pyramid(tex: np.ndarray, levels: int = 5):
    """2x2-average mip chain for minification anti-aliasing (distant
    surfaces would otherwise alias/flicker frame to frame, which no real
    camera does — lens + sensor integrate)."""
    pyr = [tex]
    cur = tex
    for _ in range(levels - 1):
        cur = 0.25 * (cur[0::2, 0::2] + cur[0::2, 1::2]
                      + cur[1::2, 0::2] + cur[1::2, 1::2])
        pyr.append(cur.astype(np.float32))
    return pyr


# --------------------------------------------------------------------------
# world building
# --------------------------------------------------------------------------
class Quads(NamedTuple):
    """Packed textured quads. A point on quad q is
    origin[q] + a * e1[q] + b * e2[q], (a, b) in [0, 1]^2; its texture
    coordinate is atlas[q, 0:2] + (a, b) * atlas[q, 2:4] (texels)."""

    origin: np.ndarray   # [Q, 3] float32
    e1: np.ndarray       # [Q, 3]
    e2: np.ndarray       # [Q, 3]
    atlas: np.ndarray    # [Q, 4] (u0, v0, du, dv) texels
    valid: np.ndarray    # [Q] bool


def curved_trajectory(n_frames: int, step: float = 0.8,
                      segments=((0.0, 200),), seed: int = 0,
                      speed_jitter: float = 0.15) -> np.ndarray:
    """[F, 4, 4] world->camera poses along a piecewise-curved street path.

    `segments` = ((yaw_rate_rad_per_frame, n_frames), ...) cycled until
    n_frames; per-frame speed jitter models accelerations. Ground truth for
    ATE; also feeds `build_street_world` so the geometry follows the road.
    """
    rng = np.random.default_rng(seed)
    rates = []
    while len(rates) < n_frames:
        for rate, n in segments:
            rates.extend([rate] * n)
    rates = np.asarray(rates[:n_frames])

    poses = np.zeros((n_frames, 4, 4), np.float32)
    yaw = 0.0
    pos = np.zeros(3)
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R_cw = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i, :3, :3] = R_cw.T
        poses[i, :3, 3] = -R_cw.T @ pos
        poses[i, 3, 3] = 1.0
        v = step * (1.0 + speed_jitter * rng.standard_normal())
        pos = pos + R_cw @ np.array([0.0, 0.0, max(0.1, v)])
        yaw += rates[i]
    return poses


def camera_centers(poses_wc: np.ndarray) -> np.ndarray:
    R = poses_wc[:, :3, :3]
    t = poses_wc[:, :3, 3]
    return -np.einsum("fij,fi->fj", R, t)


def build_street_world(poses_wc: np.ndarray, seed: int = 0,
                       tex_size: int = 2048,
                       road_half_width: float = 7.0,
                       wall_offset: float = 8.0,
                       wall_height: float = 6.0,
                       tile_len: float = 10.0,
                       billboard_every: float = 14.0,
                       texel_density: float = 48.0) -> Quads:
    """Generate the street-corridor geometry along a camera path: ground
    tiles, left/right facade walls, and occluding billboards, each with a
    random atlas rect (texel density ~constant so texture frequency scales
    correctly with distance)."""
    rng = np.random.default_rng(seed + 1)
    centers = camera_centers(poses_wc)
    # resample path by arc length
    seg = np.diff(centers, axis=0)
    seg_len = np.linalg.norm(seg[:, [0, 2]], axis=1)
    s_cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = float(s_cum[-1])

    def path_at(s):
        # linear extrapolation beyond both ends (the world must extend WELL
        # past the last camera pose, or the far field turns to featureless
        # sky and tracking starves into a reset storm — observed directly:
        # 8 resets/60 frames with a world ending 30 m out vs 1 with 120 m)
        i = np.searchsorted(s_cum, s) - 1
        i = np.clip(i, 0, len(seg) - 1)
        f = (s - s_cum[i]) / max(seg_len[i], 1e-6)
        p = centers[i] + f * seg[i]
        tdir = seg[i] / max(np.linalg.norm(seg[i]), 1e-9)
        return p, tdir

    origins, e1s, e2s, rects = [], [], [], []

    def rect_for(w_m: float, h_m: float):
        du = min(int(w_m * texel_density), tex_size - 2)
        dv = min(int(h_m * texel_density), tex_size - 2)
        u0 = rng.integers(0, tex_size - du)
        v0 = rng.integers(0, tex_size - dv)
        return [u0, v0, du, dv]

    def add_quad(origin, e1, e2):
        origins.append(origin)
        e1s.append(e1)
        e2s.append(e2)
        rects.append(rect_for(np.linalg.norm(e1), np.linalg.norm(e2)))

    # start the world slightly behind the first camera
    s = -tile_len
    ground_y = CAM_HEIGHT
    while s < total + 120.0:
        p, tdir = path_at(s)
        lat = np.array([tdir[2], 0.0, -tdir[0]])   # 90 deg right of tangent
        fwd = tdir * (tile_len + 1.0)              # overlap hides seams
        base = np.array([p[0], ground_y, p[2]])
        # ground: two half-width tiles (distinct texture left/right of lane)
        add_quad(base - lat * road_half_width, lat * road_half_width, fwd)
        add_quad(base, lat * road_half_width, fwd)
        # facade walls
        up = np.array([0.0, -wall_height, 0.0])
        add_quad(base - lat * wall_offset, fwd, up)
        add_quad(base + lat * wall_offset, fwd, up)
        s += tile_len

    # billboards/occluders along the roadside
    s = 6.0
    while s < total + 100.0:
        p, tdir = path_at(s)
        lat = np.array([tdir[2], 0.0, -tdir[0]])
        side = rng.choice([-1.0, 1.0])
        off = rng.uniform(2.5, 5.5)
        w = rng.uniform(1.2, 3.0)
        h = rng.uniform(1.5, 3.5)
        base = np.array([p[0], ground_y, p[2]]) + lat * (side * off)
        # face across the road, tilted a little
        face = lat * (-side) + tdir * rng.uniform(-0.3, 0.3)
        face = face / np.linalg.norm(face)
        edge = np.array([face[2], 0.0, -face[0]]) * w
        add_quad(base - edge * 0.5, edge, np.array([0.0, -h, 0.0]))
        s += billboard_every * rng.uniform(0.7, 1.4)

    Q = len(origins)
    return Quads(
        origin=np.asarray(origins, np.float32),
        e1=np.asarray(e1s, np.float32),
        e2=np.asarray(e2s, np.float32),
        atlas=np.asarray(rects, np.float32),
        valid=np.ones(Q, bool),
    )


def cull_quads(quads: Quads, pose_wc: np.ndarray, q_max: int,
               z_near: float = -15.0, z_far: float = 140.0) -> Quads:
    """Host-side per-frame culling: keep the q_max nearest quads whose
    center lies in the camera's z range, padded to static shape."""
    R = pose_wc[:3, :3]
    t = pose_wc[:3, 3]
    c = quads.origin + 0.5 * quads.e1 + 0.5 * quads.e2
    pc = c @ R.T + t
    ok = quads.valid & (pc[:, 2] > z_near) & (pc[:, 2] < z_far) \
        & (np.abs(pc[:, 0]) < 80.0)
    idx = np.nonzero(ok)[0]
    order = np.argsort(pc[idx, 2])
    idx = idx[order][:q_max]
    n = len(idx)
    pad = q_max - n

    def pk(a, fill=0.0):
        out = np.concatenate([a[idx], np.full((pad,) + a.shape[1:], fill,
                                              a.dtype)], axis=0)
        return out

    return Quads(
        origin=pk(quads.origin), e1=pk(quads.e1), e2=pk(quads.e2),
        atlas=pk(quads.atlas),
        valid=np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
    )


# --------------------------------------------------------------------------
# renderer
# --------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("height", "width", "ss"))
def render_frame(
    origin, e1, e2, atlas, valid, mips, pose_wc, K_inv,
    *, height: int, width: int, ss: int = 1,
    gain: float = 1.0, bias: float = 0.0, noise_sigma: float = 1.5,
    noise_key=None,
) -> jnp.ndarray:
    """Ray-cast one frame. Returns uint8 [height, width].

    mips: tuple of [S/2^l, S/2^l] texture mip levels (trilinear-selected by
    the screen-space texel footprint — minification anti-aliasing).
    One lax.scan over quads keeps memory at O(H*W).
    """
    H, W = height * ss, width * ss
    # ray directions and plane intersections need full f32, not TF32
    # (utils/parity's "renderer" check catches this)
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    R = pose_wc[:3, :3]
    t = pose_wc[:3, 3]
    cw = -mm(R.T, t)                              # camera center, world

    vv, uu = jnp.meshgrid(
        (jnp.arange(H, dtype=jnp.float32) + 0.5) / ss - 0.5,
        (jnp.arange(W, dtype=jnp.float32) + 0.5) / ss - 0.5,
        indexing="ij")
    ones = jnp.ones_like(uu)
    d_cam = mm(jnp.stack([uu, vv, ones], -1), K_inv.T)   # [H, W, 3]
    d_w = mm(d_cam, R)                                   # R^T @ d per pixel

    big = jnp.float32(1e9)
    init = (jnp.full((H, W), big),                       # best t
            jnp.zeros((H, W)), jnp.zeros((H, W)),        # best a, b
            jnp.full((H, W), -1, jnp.int32))             # best quad index

    # quads are intersected in CHUNKS of 8, vectorized over the chunk, with
    # the ray/plane algebra expanded to per-quad scalars so no [C, H, W, 3]
    # intermediate exists (a 64-step scalar scan spent 32 ms/frame on
    # sequential-step overhead). Each chunk member folds into the carry
    # with plain selects on a QUAD-INDEX carry — per-pixel argmin +
    # take_along_axis + a per-step [H, W, 4] rect gather cost ~90 ms/frame
    # of XLA gather lowering (round-4 profile); the index carry replaces
    # all of it with one tiny [Q]-table lookup after the scan.
    CH = 8
    Q = origin.shape[0]
    pad_q = (-Q) % CH

    def chunked(x, fill=0.0):
        if pad_q:
            x = jnp.concatenate(
                [x, jnp.full((pad_q,) + x.shape[1:], fill, x.dtype)])
        return x.reshape((-1, CH) + x.shape[1:])

    def hit_chunk(carry, q):
        bt, ba, bb, bqi = carry
        o, v1, v2, ok, qidx = q                          # [C, ...]
        n = jnp.cross(v1, v2)                            # [C, 3]
        hp = jax.lax.Precision.HIGHEST
        denom = jnp.einsum("hwk,ck->chw", d_w, n, precision=hp)
        denom = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
        on = jnp.einsum("ck,ck->c", o - cw, n, precision=hp)
        tt = on[:, None, None] / denom                   # [C, H, W]
        # a = ((cw - o + tt d_w) . v1) / |v1|^2, expanded so the per-pixel
        # part is two einsums, not a [C, H, W, 3] point buffer
        inv_v1 = 1.0 / jnp.maximum(jnp.einsum("ck,ck->c", v1, v1), 1e-9)
        inv_v2 = 1.0 / jnp.maximum(jnp.einsum("ck,ck->c", v2, v2), 1e-9)
        dv1 = jnp.einsum("hwk,ck->chw", d_w, v1, precision=hp)
        dv2 = jnp.einsum("hwk,ck->chw", d_w, v2, precision=hp)
        co1 = jnp.einsum("ck,ck->c", cw - o, v1, precision=hp)
        co2 = jnp.einsum("ck,ck->c", cw - o, v2, precision=hp)
        a = (co1[:, None, None] + tt * dv1) * inv_v1[:, None, None]
        b = (co2[:, None, None] + tt * dv2) * inv_v2[:, None, None]
        z = tt * d_cam[None, ..., 2]
        good = (ok[:, None, None] & (z > 0.2)
                & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0))
        tt_m = jnp.where(good, tt, big)
        # fold the chunk sequentially (static unroll): strict < keeps the
        # earliest quad on ties, matching the host reference tracer
        for c in range(CH):
            win = tt_m[c] < bt
            bt = jnp.where(win, tt_m[c], bt)
            ba = jnp.where(win, a[c], ba)
            bb = jnp.where(win, b[c], bb)
            bqi = jnp.where(win, qidx[c], bqi)
        return (bt, ba, bb, bqi), None

    inv_v1_all = 1.0 / jnp.maximum(jnp.einsum("qk,qk->q", e1, e1), 1e-9)
    den_q = atlas[:, 2] * jnp.sqrt(inv_v1_all)           # texel density [Q]
    qs = (chunked(origin), chunked(e1), chunked(e2),
          chunked(valid, fill=False),
          chunked(jnp.arange(Q, dtype=jnp.int32), fill=-1))
    (bt, ba, bb, bqi), _ = jax.lax.scan(hit_chunk, init, qs)
    hit = bqi >= 0
    qi = jnp.maximum(bqi, 0)
    brect = atlas[qi]                                    # [H, W, 4]
    bden = den_q[qi]

    # texture coords (level 0 texels) + lod from the texel footprint:
    # screen px covers (t / fx_eff) meters -> t * density / fx texels
    tu = brect[..., 0] + ba * brect[..., 2]
    tv = brect[..., 1] + bb * brect[..., 3]
    fx_eff = ss / K_inv[0, 0]
    lod = jnp.log2(jnp.maximum(bt * bden / fx_eff, 1e-6))
    lod = jnp.clip(lod, 0.0, len(mips) - 1.001)
    l0i = jnp.floor(lod).astype(jnp.int32)
    frac = lod - l0i
    l1i = jnp.minimum(l0i + 1, len(mips) - 1)

    # trilinear mip sampling against ONE flattened texture: per pixel only
    # the two adjacent levels matter, so gather 2 levels x 4 bilinear taps
    # (8 big gathers) instead of sampling every level. (A round-4 attempt
    # to halve the taps with NEAREST-level sampling was REVERTED: the mip
    # pop as a surface crosses a level boundary is temporally correlated
    # texture change, and the LK photometric gate started dropping healthy
    # tracks — the 400-frame longrun route went from 1-2 resets to 11, and
    # blackout-relocalization recovered at a broken scale. The taps are
    # NOT the renderer's bottleneck anyway — the per-step argmin/gather
    # folding was; see the scan above.)
    sizes = np.array([m.shape[0] for m in mips], np.int32)
    level_off = np.concatenate(
        [[0], np.cumsum([m.size for m in mips])])[:-1].astype(np.int32)
    flat_tex = jnp.concatenate([m.ravel() for m in mips])
    sizes_d = jnp.asarray(sizes)
    off_d = jnp.asarray(level_off)

    def sample_dyn(li):
        scale = jnp.exp2(-li.astype(jnp.float32))
        S = sizes_d[li]                                  # [H, W] int32
        Sf = S.astype(jnp.float32)
        u = jnp.clip(tu * scale, 0.0, Sf - 1.001)
        v = jnp.clip(tv * scale, 0.0, Sf - 1.001)
        u0 = jnp.floor(u).astype(jnp.int32)
        v0 = jnp.floor(v).astype(jnp.int32)
        fu = u - u0
        fv = v - v0
        idx = off_d[li] + v0 * S + u0
        t00 = jnp.take(flat_tex, idx)
        t01 = jnp.take(flat_tex, idx + 1)
        t10 = jnp.take(flat_tex, idx + S)
        t11 = jnp.take(flat_tex, idx + S + 1)
        return (t00 * (1 - fu) * (1 - fv) + t01 * fu * (1 - fv)
                + t10 * (1 - fu) * fv + t11 * fu * fv)

    val = (1.0 - frac) * sample_dyn(l0i) + frac * sample_dyn(l1i)

    # sky: smooth vertical gradient (nearly featureless, like real sky)
    elev = d_cam[..., 1]                                  # y down: sky is <0
    sky = 205.0 + 28.0 * jnp.clip(elev, -1.0, 0.3)
    img = jnp.where(hit, val, sky)

    if ss > 1:
        img = img.reshape(height, ss, width, ss).mean(axis=(1, 3))

    # illumination + vignette + sensor noise
    cyy, cxx = (height - 1) / 2.0, (width - 1) / 2.0
    vg_v = (jnp.arange(height, dtype=jnp.float32) - cyy) / cyy
    vg_u = (jnp.arange(width, dtype=jnp.float32) - cxx) / cxx
    r2 = vg_v[:, None] ** 2 + vg_u[None, :] ** 2
    img = img * gain * (1.0 - 0.18 * r2 / 2.0) + bias
    if noise_key is not None:
        img = img + noise_sigma * jax.random.normal(noise_key, img.shape)
    return jnp.clip(img, 0, 255).astype(jnp.uint8)


# --------------------------------------------------------------------------
# sequence driver
# --------------------------------------------------------------------------
class TexturedSequence:
    """Iterable of rendered frames over a procedurally built street world.

    Renders on demand (jitted; device-resident output) so arbitrarily long
    sequences need no precomputed storage. Ground-truth trajectory in
    `.poses`. Illumination drifts sinusoidally with `light_period`.
    """

    def __init__(self, n_frames: int = 100, height: int = 376,
                 width: int = 1241, step: float = 0.8,
                 segments=((0.0, 80), (0.006, 60), (0.0, 80), (-0.008, 50)),
                 seed: int = 0, q_max: int = 64, tex_size: int = 2048,
                 photo: Optional[np.ndarray] = None, ss: int = 1,
                 light_period: float = 400.0, light_amp: float = 0.12,
                 cam: Optional[Camera] = None,
                 mip_levels: int = 5, noise_sigma: float = 1.5):
        self.n_frames = n_frames
        self.height, self.width = height, width
        self.poses = curved_trajectory(n_frames, step=step,
                                       segments=segments, seed=seed)
        self.cam = cam if cam is not None else kitti_camera()
        self.quads = build_street_world(self.poses, seed=seed,
                                        tex_size=tex_size)
        tex = make_texture(tex_size, seed=seed, photo=photo)
        self.mips = tuple(jnp.asarray(m) for m in _mip_pyramid(
            tex, mip_levels))
        # K_inv stays HOST-side numpy: render_frame device_puts it per call
        # (36 bytes); keeping it on device made every host consumer
        # (utils/parity's float64 ray caster) pay a device->host sync
        K = np.asarray(self.cam.K, np.float64)
        self.K_inv = np.linalg.inv(K).astype(np.float32)
        self.q_max = q_max
        self.ss = ss
        self.seed = seed
        self.light_period = light_period
        self.light_amp = light_amp
        self.noise_sigma = noise_sigma

    def frame(self, f: int) -> jnp.ndarray:
        culled = cull_quads(self.quads, self.poses[f], self.q_max)
        gain = 1.0 + self.light_amp * np.sin(
            2 * np.pi * f / self.light_period)
        bias = 6.0 * np.sin(2 * np.pi * f / (self.light_period * 1.7))
        key = jax.random.PRNGKey(self.seed * 1000003 + f)
        return render_frame(
            jnp.asarray(culled.origin), jnp.asarray(culled.e1),
            jnp.asarray(culled.e2), jnp.asarray(culled.atlas),
            jnp.asarray(culled.valid), self.mips,
            jnp.asarray(self.poses[f]), self.K_inv,
            height=self.height, width=self.width, ss=self.ss,
            gain=float(gain), bias=float(bias),
            noise_sigma=self.noise_sigma, noise_key=key,
        )

    def __len__(self):
        return self.n_frames

    def __iter__(self):
        for f in range(self.n_frames):
            yield self.frame(f)
