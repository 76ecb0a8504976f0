"""Pyramidal Lucas-Kanade as a Pallas kernel on the Triton route (GPU).

Same maths as `lk.track` (inverse-compositional KLT with zero-mean
residuals, OpenCV-style status), one kernel launch per pyramid level:

  * one program per block of `BLOCK_TRACKS` tracks;
  * the (2*half+1)^2 window is flattened onto a power-of-two lane axis
    (121 pixels -> 128 lanes for the 11x11 window) and the spare lanes are
    masked out of every sum;
  * template, gradients and the inverse 2x2 normal matrix are computed
    once per level and stay in registers;
  * the image is read through L2 with gathered loads (4 taps per bilinear
    sample), never staged in shared memory;
  * the iteration runs on-chip and stops as soon as every track of the
    block is frozen.

The early exit is exact, not an approximation: `lk.track` zeroes a track's
update once its step is below `eps`, after which every later iteration
recomputes the same sub-`eps` step at the same position. Stopping when
the whole block is frozen therefore gives the `iters`-iteration result.
Tracks with `mask` False are frozen from the start (`lk.track` iterates
them, but their status is False either way).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ya_vo_tpu.tracking.lk import FlowResult, build_pyramid

# fastest of 16-128 tracks x 4-8 warps on an H100 (all within 6%,
# tools/profile_step.py)
BLOCK_TRACKS = 16
NUM_WARPS = 4


def _sample(img_ref, u, v, H: int, W: int):
    """Bilinear img[v, u] from a flat [H*W] image ref, `lk._bilinear`'s
    clamping."""
    u = jnp.clip(u, 0.0, W - 1.001)
    v = jnp.clip(v, 0.0, H - 1.001)
    uf = jnp.floor(u)
    vf = jnp.floor(v)
    du = u - uf
    dv = v - vf
    i = vf.astype(jnp.int32) * W + uf.astype(jnp.int32)
    i00 = img_ref[i]
    i01 = img_ref[i + 1]
    i10 = img_ref[i + W]
    i11 = img_ref[i + W + 1]
    return (i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
            + i10 * (1 - du) * dv + i11 * du * dv)


def _level_kernel(u0_ref, v0_ref, su_ref, sv_ref, valid_ref, img0_ref,
                  img1_ref, u_out, v_out, ok_out, res_out, std_out, *,
                  H: int, W: int, half: int, lanes: int, iters: int,
                  eps: float, min_eig: float):
    win = 2 * half + 1
    npix = float(win * win)
    p = jax.lax.broadcasted_iota(jnp.int32, (1, lanes), 1)
    pm = (p < win * win).astype(jnp.float32)          # [1, lanes]
    ou = (jax.lax.rem(p, win) - half).astype(jnp.float32)
    ov = (jax.lax.div(p, win) - half).astype(jnp.float32)

    u0 = u0_ref[...][:, None]
    v0 = v0_ref[...][:, None]
    U = u0 + ou
    V = v0 + ov
    T = _sample(img0_ref, U, V, H, W) * pm
    gx = 0.5 * (_sample(img0_ref, U + 1.0, V, H, W)
                - _sample(img0_ref, U - 1.0, V, H, W)) * pm
    gy = 0.5 * (_sample(img0_ref, U, V + 1.0, H, W)
                - _sample(img0_ref, U, V - 1.0, H, W)) * pm

    gxx = jnp.sum(gx * gx, axis=1)
    gxy = jnp.sum(gx * gy, axis=1)
    gyy = jnp.sum(gy * gy, axis=1)
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    eig = (trace - jnp.sqrt(jnp.maximum(trace * trace - 4 * det, 0.0))) \
        * 0.5 / npix
    cond_ok = eig > min_eig
    det_safe = jnp.where(jnp.abs(det) < 1e-6, 1e-6, det)
    iG00 = gyy / det_safe
    iG01 = -gxy / det_safe
    iG11 = gxx / det_safe

    active = (cond_ok & (valid_ref[...] > 0)).astype(jnp.int32)

    def cond(carry):
        it, _, _, act = carry
        return (it < iters) & (jnp.max(act) > 0)

    def body(carry):
        it, u, v, act = carry
        I = _sample(img1_ref, u[:, None] + ou, v[:, None] + ov, H, W)
        err = (I - T) * pm
        err = (err - jnp.sum(err, axis=1, keepdims=True) / npix) * pm
        bx = jnp.sum(err * gx, axis=1)
        by = jnp.sum(err * gy, axis=1)
        ddu = -(iG00 * bx + iG01 * by)
        ddv = -(iG01 * bx + iG11 * by)
        moving = (act > 0) & (jnp.sqrt(ddu * ddu + ddv * ddv) >= eps)
        u = jnp.where(moving, u + ddu, u)
        v = jnp.where(moving, v + ddv, v)
        return it + 1, u, v, moving.astype(jnp.int32)

    _, u, v, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), su_ref[...], sv_ref[...], active))

    # gate residual stays raw |I - T| (see lk._track_level)
    I = _sample(img1_ref, u[:, None] + ou, v[:, None] + ov, H, W)
    t_mean = jnp.sum(T, axis=1) / npix
    t_std = jnp.sqrt(jnp.maximum(
        jnp.sum(T * T, axis=1) / npix - t_mean * t_mean, 0.0))
    u_out[...] = u
    v_out[...] = v
    ok_out[...] = cond_ok.astype(jnp.int32)
    res_out[...] = jnp.sum(jnp.abs(I - T) * pm, axis=1) / npix
    std_out[...] = t_std


def _track_level(img0, img1, uv0, seed, valid, *, half, iters, eps, min_eig,
                 interpret):
    """One pyramid level for all tracks; N must be a multiple of
    BLOCK_TRACKS. Returns (uv [N, 2], cond_ok [N], residual, t_std)."""
    H, W = img0.shape
    N = uv0.shape[0]
    lanes = pl.next_power_of_2((2 * half + 1) ** 2)
    kernel = functools.partial(
        _level_kernel, H=H, W=W, half=half, lanes=lanes, iters=iters,
        eps=eps, min_eig=min_eig)
    blk = pl.BlockSpec((BLOCK_TRACKS,), lambda i: (i,))
    full = pl.BlockSpec((H * W,), lambda i: (0,))
    f32 = jax.ShapeDtypeStruct((N,), jnp.float32)
    u, v, ok, res, std = pl.pallas_call(
        kernel,
        grid=(N // BLOCK_TRACKS,),
        in_specs=[blk] * 5 + [full, full],
        out_specs=[blk] * 5,
        out_shape=[f32, f32, jax.ShapeDtypeStruct((N,), jnp.int32), f32, f32],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="lk_level",
    )(uv0[:, 0], uv0[:, 1], seed[:, 0], seed[:, 1], valid.astype(jnp.int32),
      img0.reshape(-1), img1.reshape(-1))
    return jnp.stack([u, v], axis=-1), ok > 0, res, std


@functools.partial(
    jax.jit,
    static_argnames=("levels", "half", "iters", "eps", "min_eig",
                     "max_residual", "rel_residual", "interpret"),
)
def track(
    img0: jnp.ndarray,
    img1: jnp.ndarray,
    uv0: jnp.ndarray,
    uv_init: jnp.ndarray,
    mask: jnp.ndarray,
    *,
    levels: int = 3,
    half: int = 5,
    iters: int = 30,
    eps: float = 0.01,
    min_eig: float = 1e-3,
    max_residual: float = 12.0,
    rel_residual: float = 0.5,
    interpret: bool = False,
) -> FlowResult:
    """Drop-in for `lk.track` (same arguments, same FlowResult). `uv` of a
    track whose `mask` is False is its seed, not a tracked position."""
    img0 = img0.astype(jnp.float32)
    img1 = img1.astype(jnp.float32)
    H, W = img0.shape
    N = uv0.shape[0]
    pad = -N % BLOCK_TRACKS
    uv0_p = jnp.pad(uv0, ((0, pad), (0, 0)))
    uv = jnp.pad(uv_init, ((0, pad), (0, 0)))
    mask_p = jnp.pad(mask, (0, pad))
    pyr0 = build_pyramid(img0, levels)
    pyr1 = build_pyramid(img1, levels)

    uv = uv / 2.0 ** (levels - 1)
    cond_all = jnp.ones(N + pad, bool)
    for lvl in range(levels - 1, -1, -1):
        uv, cond_ok, residual, t_std = _track_level(
            pyr0[lvl], pyr1[lvl], uv0_p / 2.0 ** lvl, uv, mask_p,
            half=half, iters=iters, eps=eps, min_eig=min_eig,
            interpret=interpret)
        cond_all = cond_all & cond_ok
        if lvl > 0:
            uv = uv * 2.0

    uv, cond_all, residual, t_std = (
        uv[:N], cond_all[:N], residual[:N], t_std[:N])
    in_bounds = (
        (uv[:, 0] >= half) & (uv[:, 0] < W - half)
        & (uv[:, 1] >= half) & (uv[:, 1] < H - half)
    )
    gate = jnp.maximum(max_residual, rel_residual * t_std)
    status = mask & cond_all & in_bounds & (residual < gate)
    return FlowResult(uv=uv, status=status, residual=residual)
