"""Tracing / profiling utilities.

The reference's observability is hand-inserted chrono spans printed with
cout (reference: src/LoopHandler.cc:471-482, src/FastDetector.cc:289-349 —
SURVEY.md §5). Here:

  * `span()` — wall-clock context manager that forces device completion
    (`block_until_ready` fencing for honest numbers);
  * `trace()` — wraps `jax.profiler.trace` for device traces viewable in
    TensorBoard/XProf;
  * `device_info()` / `require_gpu()` — name the device every measurement
    ran on, and refuse to measure without a GPU;
  * `MetricsLog` — structured per-frame metrics accumulation + summary,
    replacing printf-style status lines.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time
from collections import defaultdict
from typing import Dict, List, Optional

import jax


@contextlib.contextmanager
def span(name: str, store: Optional[dict] = None, sync: bool = True):
    """Time a block; with sync=True, fences outstanding device work so the
    measurement is not async-dispatch fiction."""
    if sync:
        jax.effects_barrier()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            jax.effects_barrier()
        dt = (time.perf_counter() - t0) * 1e3
        if store is not None:
            store[name] = store.get(name, 0.0) + dt


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card (a card
    set below its maximum power runs slower under load, so every number
    is kept beside this line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_info() -> dict:
    """The device as JAX reports it, plus the GPU's name and power limit."""
    d = jax.devices()[0]
    info = {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()), "jax": jax.__version__}
    if d.platform == "gpu":
        name, limit = gpu_name_and_power_limit().split(",", 1)
        info.update(gpu_name=name.strip(), power_limit=limit.strip())
    return info


def require_gpu() -> None:
    """Measurement paths run on a GPU or not at all: a CPU number must
    never be reported under a device metric."""
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {jax.default_backend()!r}")


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/jax-trace"):
    """Capture a jax.profiler trace around a block."""
    with jax.profiler.trace(log_dir):
        yield


class MetricsLog:
    """Per-frame structured metrics with aggregate summaries."""

    def __init__(self):
        self.frames: List[dict] = []

    def log(self, **kv) -> None:
        self.frames.append(kv)

    def log_frame_result(self, r) -> None:
        self.log(
            frame_id=r.frame_id, status=r.status,
            n_keypoints=r.n_keypoints, n_matches=r.n_matches,
            n_flow_inliers=r.n_flow_inliers, n_ba_inliers=r.n_ba_inliers,
            n_new_landmarks=r.n_new_landmarks, is_keyframe=r.is_keyframe,
            reset=r.reset, **{f"ms_{k}": v for k, v in r.timings_ms.items()},
        )

    def summary(self) -> Dict[str, float]:
        if not self.frames:
            return {}
        agg: Dict[str, list] = defaultdict(list)
        for f in self.frames:
            for k, v in f.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    agg[k].append(float(v))
        out = {}
        for k, vs in agg.items():
            out[f"{k}_mean"] = sum(vs) / len(vs)
        out["n_frames"] = float(len(self.frames))
        out["n_resets"] = float(sum(1 for f in self.frames if f.get("reset")))
        out["n_keyframes"] = float(
            sum(1 for f in self.frames if f.get("is_keyframe")))
        return out

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for row in self.frames:
                f.write(json.dumps(row) + "\n")
