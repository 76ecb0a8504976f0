"""Brute-force Hamming descriptor matching as one integer matrix product.

The reference does an O(N1*N2*32) scalar triple loop with a bit-twiddling
popcount (reference: src/BriefDescriptor.cc:163-183 matchFeatures,
:139-160 hammingDistance/popCount). Here the same computation is cast as a
matmul: unpack each 256-bit descriptor to a +-1 int8 vector d in {-1,+1}^256;
then  hamming(a, b) = (256 - <a, b>) / 2,  so the full N1 x N2 distance
matrix is one int8 x int8 -> int32 product, which a GPU runs on its
integer tensor cores (SURVEY.md §7.1 "XOR + popcount contraction shaped
like an int8 matmul").

Match selection and the reference's `d < max(2*minDist, thr)` filter
(src/BriefDescriptor.cc:213-231, threshold 20 at LoopHandler.cc:537) are
batched argmin/reductions; a mutual-best (cross-check) filter is added on
top (the reference matches one-directionally).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

INVALID_DIST = 100000


class MatchResult(NamedTuple):
    """Fixed-capacity match set: for each keypoint in frame 1 (query), the
    best keypoint index in frame 2 (train)."""

    idx2: jnp.ndarray   # [K1] int32 — best match in frame 2 (undefined if !mask)
    dist: jnp.ndarray   # [K1] int32 — Hamming distance
    mask: jnp.ndarray   # [K1] bool — match survives all filters

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.mask.astype(jnp.int32))


def unpack_pm1(desc: jnp.ndarray) -> jnp.ndarray:
    """[K, W] uint32 packed bits -> [K, 32*W] int8 in {-1, +1}."""
    K, W = desc.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(K, W * 32).astype(jnp.int8)
    return bits * jnp.int8(2) - jnp.int8(1)


def hamming_matrix(
    desc1: jnp.ndarray, desc2: jnp.ndarray,
    mask1: jnp.ndarray, mask2: jnp.ndarray,
) -> jnp.ndarray:
    """[K1, K2] int32 Hamming distances; invalid rows/cols = INVALID_DIST."""
    n_bits = desc1.shape[1] * 32
    dots = jax.lax.dot_general(
        unpack_pm1(desc1), unpack_pm1(desc2),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # [K1, K2]
    dist = (n_bits - dots) // 2
    valid = mask1[:, None] & mask2[None, :]
    return jnp.where(valid, dist, INVALID_DIST)


@functools.partial(jax.jit, static_argnames=("abs_threshold", "cross_check"))
def match(
    desc1: jnp.ndarray, desc2: jnp.ndarray,
    mask1: jnp.ndarray, mask2: jnp.ndarray,
    *,
    abs_threshold: int = 20,
    cross_check: bool = True,
) -> MatchResult:
    """Nearest-neighbor Hamming matching with the reference's distance filter.

    Keep a match iff dist < max(2 * min_dist_over_all_matches, abs_threshold)
    (reference removeOutliers, src/BriefDescriptor.cc:213-231), optionally
    requiring mutual best.
    """
    D = hamming_matrix(desc1, desc2, mask1, mask2)  # [K1, K2]
    idx2 = jnp.argmin(D, axis=1).astype(jnp.int32)  # [K1]
    dist = jnp.min(D, axis=1)
    ok = dist < INVALID_DIST

    if cross_check:
        back = jnp.argmin(D, axis=0).astype(jnp.int32)  # [K2]
        ok = ok & (back[idx2] == jnp.arange(idx2.shape[0], dtype=jnp.int32))

    min_dist = jnp.min(jnp.where(ok, dist, INVALID_DIST))
    gate = jnp.maximum(2 * min_dist, abs_threshold)
    ok = ok & (dist < gate)
    return MatchResult(idx2=idx2, dist=dist, mask=ok)


def gather_matched_uv(
    uv1: jnp.ndarray, uv2: jnp.ndarray, result: MatchResult
):
    """Return (pts1 [K1,2], pts2 [K1,2], mask [K1]) of matched pixel pairs."""
    pts2 = uv2[result.idx2]
    return uv1, pts2, result.mask
