"""BRIEF-256 binary descriptors, deterministic and batched.

Replaces the reference's per-keypoint loop (reference:
src/BriefDescriptor.cc:86-124) with one vectorized gather over all keypoints
x all 256 tests. Two deliberate fixes vs the reference:

* The random offset table is generated ONCE from a fixed seed instead of
  re-sampled per process via std::random_device (reference
  BriefDescriptor.cc:4-20 — quirk SURVEY.md §2.4.6). Descriptors are
  reproducible across runs, which the golden tests rely on.
* Descriptors are packed [K, 8] uint32 (256 bits) instead of 32 uchar, so
  Hamming matching can bit-count on 32-bit lanes (see matching.py).

The 9x9 sigma=2.5 Gaussian pre-blur matches reference
BriefDescriptor.cc:90 (`cv::GaussianBlur(img, out, (9,9), 2.5, 2.5)`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def make_offsets(n_bits: int = 256, patch_radius: int = 8, seed: int = 42):
    """Deterministic BRIEF test table [n_bits, 4] int32 = (du1, dv1, du2, dv2),
    uniform in [-patch_radius, patch_radius] (reference draws the same range,
    BriefDescriptor.cc:10-19).

    Returned as a HOST numpy array: `describe` unrolls the test table into
    statically-shifted image views at trace time, so the
    offsets must be Python ints when tracing."""
    rng = np.random.default_rng(seed)
    offs = rng.integers(-patch_radius, patch_radius + 1, size=(n_bits, 4))
    return offs.astype(np.int32)


def gaussian_kernel_1d(ksize: int, sigma: float) -> jnp.ndarray:
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return jnp.asarray(k / k.sum(), dtype=jnp.float32)


def gaussian_blur(img_f32: jnp.ndarray, ksize: int = 9, sigma: float = 2.5):
    """Separable Gaussian blur on [H, W] float32 (SAME zero padding).

    Implemented as 2 x ksize statically-shifted multiply-adds (pure
    elementwise work that XLA fuses) rather than `lax.conv` with a
    single-channel [1, 1, H, W] kernel, for identical output. Which form
    is faster on a GPU is not measured yet."""
    k = gaussian_kernel_1d(ksize, sigma)
    half = ksize // 2
    H, W = img_f32.shape
    p = jnp.pad(img_f32, ((half, half), (0, 0)))
    out = k[0] * p[0:H, :]
    for i in range(1, ksize):
        out = out + k[i] * p[i:i + H, :]
    p = jnp.pad(out, ((0, 0), (half, half)))
    out = k[0] * p[:, 0:W]
    for i in range(1, ksize):
        out = out + k[i] * p[:, i:i + W]
    return out


def describe(
    blurred: jnp.ndarray,
    uv: jnp.ndarray,
    kp_mask: jnp.ndarray,
    offsets: np.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Compute descriptors for keypoints on a pre-blurred image.

    Dense formulation: instead of gathering 2 x 256 samples per keypoint
    (K*512 scalar gathers), build the DENSE descriptor map with 256
    statically-shifted full-image compares (one fused elementwise pass
    over the image; the test table is fixed, reference
    src/BriefDescriptor.cc:4-20) and gather one 8-word row per keypoint —
    redundant compares traded for memory locality. Verified bit-identical
    to the per-keypoint gather formulation; a per-keypoint gather may be
    the better trade on a GPU (not measured yet).

    Args:
      blurred: [H, W] float32 blurred image.
      uv: [K, 2] float32 keypoint coords (u=col, v=row).
      kp_mask: [K] bool valid keypoints (assumed inside the safe border —
        the detector enforces `border >= patch_radius + blur support`).
      offsets: [B, 4] HOST int32 test table from `make_offsets` (static at
        trace time).

    Returns:
      desc: [K, B//32] uint32 packed descriptors.
      mask: [K] bool (same as kp_mask; kept for API symmetry).
    """
    offs = np.asarray(offsets)
    H, W = blurred.shape
    R = int(np.abs(offs).max())
    # edge padding == the gather formulation's coordinate clipping
    pad = jnp.pad(blurred, R, mode="edge")

    words = []
    for w in range(offs.shape[0] // 32):
        acc = jnp.zeros((H, W), jnp.uint32)
        for b in range(32):
            du1, dv1, du2, dv2 = (int(x) for x in offs[w * 32 + b])
            s1 = pad[R + dv1: R + dv1 + H, R + du1: R + du1 + W]
            s2 = pad[R + dv2: R + dv2 + H, R + du2: R + du2 + W]
            acc = acc | ((s1 < s2).astype(jnp.uint32) << np.uint32(b))
        words.append(acc)
    dmap = jnp.stack(words, axis=-1)  # [H, W, B//32]

    u = jnp.clip(uv[..., 0].astype(jnp.int32), 0, W - 1)
    v = jnp.clip(uv[..., 1].astype(jnp.int32), 0, H - 1)
    desc = dmap[v, u]  # [K, B//32]: one row gather per keypoint
    desc = jnp.where(kp_mask[:, None], desc, 0)
    return desc, kp_mask
