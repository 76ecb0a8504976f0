"""BRIEF descriptor + Hamming matching tests: determinism (the reference's
descriptors were non-reproducible across runs, SURVEY.md §2.4.6 — ours must
not be), translation invariance, popcount correctness vs a numpy oracle,
and a two-view matching smoke on rendered frames."""

import jax.numpy as jnp
import numpy as np
import pytest

from ya_vo_tpu.features import brief, fast, matching
from ya_vo_tpu.utils import synthetic


def test_offsets_deterministic():
    a = brief.make_offsets(256, 8, seed=42)
    b = brief.make_offsets(256, 8, seed=42)
    np.testing.assert_array_equal(a, b)
    c = brief.make_offsets(256, 8, seed=43)
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    assert int(jnp.max(jnp.abs(a))) <= 8


def test_gaussian_blur_preserves_mean():
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (64, 64)).astype(np.float32))
    out = brief.gaussian_blur(img)
    # interior mean preserved (SAME padding distorts only the border)
    np.testing.assert_allclose(
        float(jnp.mean(out[8:-8, 8:-8])), float(jnp.mean(img[8:-8, 8:-8])),
        rtol=0.02,
    )


def _describe_img(img_u8, uv):
    offsets = brief.make_offsets()
    blurred = brief.gaussian_blur(jnp.asarray(img_u8, jnp.float32))
    uv = jnp.asarray(uv, jnp.float32)
    mask = jnp.ones(uv.shape[0], bool)
    return brief.describe(blurred, uv, mask, offsets)[0]


def test_translation_invariance():
    rng = np.random.default_rng(1)
    patch = rng.uniform(0, 255, (200, 200)).astype(np.uint8)
    img1 = patch
    img2 = np.roll(patch, (5, 9), axis=(0, 1))
    d1 = _describe_img(img1, [[100, 100]])
    d2 = _describe_img(img2, [[109, 105]])  # u+=9 (col), v+=5 (row)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_hamming_matches_numpy_oracle():
    rng = np.random.default_rng(2)
    d1 = rng.integers(0, 2**32, (16, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (24, 8), dtype=np.uint32)
    m1 = np.ones(16, bool)
    m2 = np.ones(24, bool)
    D = np.asarray(matching.hamming_matrix(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2)))
    # numpy oracle
    b1 = np.unpackbits(d1.view(np.uint8), axis=1)
    b2 = np.unpackbits(d2.view(np.uint8), axis=1)
    oracle = (b1[:, None, :] != b2[None, :, :]).sum(-1)
    np.testing.assert_array_equal(D, oracle)


def test_identical_descriptors_match_at_zero():
    rng = np.random.default_rng(3)
    d = jnp.asarray(rng.integers(0, 2**32, (32, 8), dtype=np.uint32))
    m = jnp.ones(32, bool)
    res = matching.match(d, d, m, m, abs_threshold=20)
    np.testing.assert_array_equal(np.asarray(res.idx2), np.arange(32))
    assert np.all(np.asarray(res.dist) == 0)
    assert int(res.count()) == 32


def test_masked_rows_never_match():
    rng = np.random.default_rng(4)
    d = jnp.asarray(rng.integers(0, 2**32, (8, 8), dtype=np.uint32))
    m1 = jnp.asarray([True] * 4 + [False] * 4)
    res = matching.match(d, d, m1, m1, abs_threshold=20)
    assert not np.any(np.asarray(res.mask)[4:])


def test_two_view_matching_rendered():
    """Detect+describe+match across two nearby synthetic views; matched
    pairs must displace consistently with the true projection flow."""
    imgs, poses, lms, cam = synthetic.render_sequence(
        n_frames=2, n_landmarks=150, height=256, width=512, step=0.25, seed=5
    )
    offsets = brief.make_offsets()
    kp, desc = [], []
    for img in imgs:
        k = fast.detect(jnp.asarray(img), max_keypoints=512, border=20)
        blurred = brief.gaussian_blur(jnp.asarray(img, jnp.float32))
        d, _ = brief.describe(blurred, k.uv, k.mask, offsets)
        kp.append(k)
        desc.append(d)
    res = matching.match(desc[0], desc[1], kp[0].mask, kp[1].mask)
    n = int(res.count())
    assert n >= 30, n
    sel = np.asarray(res.mask)
    uv1 = np.asarray(kp[0].uv)[sel]
    uv2 = np.asarray(kp[1].uv)[np.asarray(res.idx2)[sel]]
    # ground truth flow at uv1: project matching landmark motion — instead
    # compare against median flow direction; forward motion => divergence
    # from FOE, displacements should be small (< 40 px) and mostly coherent
    disp = np.linalg.norm(uv2 - uv1, axis=-1)
    assert np.median(disp) < 40.0
    # at least 80% of matches should be sub-25px (squares move slowly here)
    assert np.mean(disp < 25.0) > 0.8


@pytest.mark.parametrize("k1,k2,masked", [
    (256, 512, False),
    (2048, 2048, True),     # the production shape, with masked rows/cols
])
def test_hamming_matrix_matches_popcount(k1, k2, masked):
    """matching.hamming_matrix == the numpy byte-popcount reference the
    device parity check uses, masked entries = INVALID_DIST."""
    from ya_vo_tpu.utils.parity import popcount_hamming

    rng = np.random.default_rng(7)
    d1 = rng.integers(0, 2**32, (k1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (k2, 8), dtype=np.uint32)
    d2[: k2 // 4] = d1[: k2 // 4] ^ (1 << rng.integers(0, 32, (k2 // 4, 8))
                                      ).astype(np.uint32)   # near matches
    m1 = rng.uniform(size=k1) > 0.3 if masked else np.ones(k1, bool)
    m2 = rng.uniform(size=k2) > 0.3 if masked else np.ones(k2, bool)
    D = np.asarray(matching.hamming_matrix(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2)))
    ref = np.where(m1[:, None] & m2[None, :], popcount_hamming(d1, d2),
                   matching.INVALID_DIST)
    np.testing.assert_array_equal(D, ref)


def test_popcount_reference_matches_unpackbits():
    from ya_vo_tpu.utils.parity import popcount_hamming

    rng = np.random.default_rng(8)
    d1 = rng.integers(0, 2**32, (130, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (20, 8), dtype=np.uint32)
    b1 = np.unpackbits(d1.view(np.uint8), axis=1)
    b2 = np.unpackbits(d2.view(np.uint8), axis=1)
    np.testing.assert_array_equal(popcount_hamming(d1, d2),
                                  (b1[:, None, :] != b2[None, :, :]).sum(-1))
