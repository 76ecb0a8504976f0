"""The Triton LK kernel (`lk_gpu.track`) against XLA's `lk.track`.

Each comparison runs twice: in Pallas interpret mode (here on the CPU) and
compiled for the card (`gpu` marker; skips without a GPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ya_vo_tpu.features.brief import gaussian_blur
from ya_vo_tpu.tracking import lk, lk_gpu

MODES = [pytest.param(True, id="interpret"),
         pytest.param(False, id="compiled", marks=pytest.mark.gpu)]


@pytest.fixture(params=MODES)
def interpret(request):
    if not request.param:
        request.getfixturevalue("on_gpu")
    return request.param


def _pair(shift=(2.0, 3.0), size=(96, 200), seed=0):
    rng = np.random.default_rng(seed)
    img0 = np.asarray(gaussian_blur(
        jnp.asarray(rng.uniform(0, 255, size).astype(np.float32)), 5, 1.2))
    img1 = np.roll(img0, (int(shift[0]), int(shift[1])), axis=(0, 1))
    return img0, img1


def _assert_same(ref, got, mask):
    m = np.asarray(mask)
    np.testing.assert_array_equal(np.asarray(got.status), np.asarray(ref.status))
    np.testing.assert_allclose(np.asarray(got.uv)[m], np.asarray(ref.uv)[m],
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.residual)[m],
                               np.asarray(ref.residual)[m], atol=1e-3)


@pytest.mark.parametrize("n", [1, lk_gpu.BLOCK_TRACKS + 1, 45])
def test_matches_lk_track(interpret, n):
    """N not a multiple of the block, some tracks masked, some at and past
    the image border."""
    img0, img1 = _pair()
    rng = np.random.default_rng(n)
    uv0 = np.stack([rng.uniform(-4, 204, n), rng.uniform(-4, 100, n)],
                   -1).astype(np.float32)
    uv0[: min(n, 4)] = [[0, 0], [199, 95], [5, 50], [100, 2]][: min(n, 4)]
    mask = rng.uniform(size=n) > 0.2
    mask[0] = True
    ref = lk.track(img0, img1, uv0, uv0, mask)
    got = lk_gpu.track(img0, img1, uv0, uv0, mask, interpret=interpret)
    assert got.uv.shape == (n, 2) and got.status.shape == (n,)
    _assert_same(ref, got, mask)


@pytest.mark.parametrize("iters", [1, 3])
def test_each_iteration_matches(interpret, iters):
    """Capped before convergence, the kernel still takes lk.track's steps."""
    img0, img1 = _pair(shift=(4.0, -5.0))
    rng = np.random.default_rng(7)
    uv0 = np.stack([rng.uniform(20, 180, 40), rng.uniform(20, 76, 40)],
                   -1).astype(np.float32)
    mask = np.ones(40, bool)
    kw = dict(levels=1, iters=iters)
    ref = lk.track(img0, img1, uv0, uv0, mask, **kw)
    got = lk_gpu.track(img0, img1, uv0, uv0, mask, interpret=interpret, **kw)
    _assert_same(ref, got, mask)


def test_early_exit_equals_full_iterations(interpret):
    """Integer shifts converge in a few steps, so every block stops long
    before `iters`; the result must be lk.track's after all 30."""
    img0, img1 = _pair(shift=(1.0, 1.0))
    rng = np.random.default_rng(3)
    uv0 = np.stack([rng.uniform(20, 180, 64), rng.uniform(20, 76, 64)],
                   -1).astype(np.float32)
    mask = np.ones(64, bool)
    few = lk.track(img0, img1, uv0, uv0, mask, levels=1, iters=8)
    full = lk.track(img0, img1, uv0, uv0, mask, levels=1, iters=30)
    # converged: 8 and 30 iterations agree, so the kernel's loop exits early
    np.testing.assert_array_equal(np.asarray(few.uv), np.asarray(full.uv))
    got = lk_gpu.track(img0, img1, uv0, uv0, mask, levels=1, iters=30,
                       interpret=interpret)
    _assert_same(full, got, mask)
    flow = np.asarray(got.uv)[np.asarray(got.status)] - \
        uv0[np.asarray(got.status)]
    np.testing.assert_allclose(flow, 1.0, atol=0.05)


def test_all_masked_keeps_seeds():
    img0, img1 = _pair()
    uv0 = np.full((5, 2), 50.0, np.float32)
    seed = uv0 + 1.5
    got = lk_gpu.track(img0, img1, uv0, seed, np.zeros(5, bool),
                       interpret=True)
    assert not np.asarray(got.status).any()
    np.testing.assert_allclose(np.asarray(got.uv), seed)


def test_auto_track_dispatch(monkeypatch):
    """GPU -> the kernel, any other backend -> lk.track."""
    calls = []
    monkeypatch.setattr(lk_gpu, "track", lambda *a, **k: calls.append("gpu"))
    monkeypatch.setattr(lk, "track", lambda *a, **k: calls.append("xla"))
    lk.auto_track()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    lk.auto_track()
    assert calls == ["xla", "gpu"]
