"""CLI runner smoke: the full run_vo entrypoint in-process on a small
synthetic sequence, exercising trajectory export, plotting, checkpointing
and the summary JSON."""

import json
import os

import numpy as np
import pytest


def test_run_vo_synthetic(tmp_path, capsys):
    import run_vo

    traj_path = str(tmp_path / "poses.txt")
    plot_path = str(tmp_path / "traj.png")
    ckpt_path = str(tmp_path / "state.npz")
    rc = run_vo.main([
        "--synthetic", "--synthetic-frames", "8",
        "--synthetic-size", "256", "768",
        "--traj", traj_path, "--plot", plot_path,
        "--checkpoint", ckpt_path,
    ])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    summary = json.loads(out)
    assert summary["frames"] == 8
    assert summary["resets"] == 0
    assert summary["ate_sim3_m"] < 0.2
    assert os.path.getsize(plot_path) > 1000
    assert os.path.exists(ckpt_path)
    rows = np.loadtxt(traj_path)
    assert rows.shape == (8, 12)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    from ya_vo_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_default_is_stable_inside_checkout(monkeypatch,
                                                         tmp_path):
    from ya_vo_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.cache_dir() == os.path.join(repo, ".jax_cache")
    monkeypatch.chdir(tmp_path)
    assert compile_cache.cache_dir() == os.path.join(repo, ".jax_cache")


def test_compile_cache_enable_points_jax_there(monkeypatch, tmp_path):
    import jax

    from ya_vo_tpu.utils import compile_cache

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py",
                                    "tools/profile_step.py"])
def test_measurement_entry_points_refuse_cpu(script):
    """Without a GPU these exit non-zero and print no result line."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, script], cwd=repo,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout
    assert "no GPU" in r.stderr
