"""Device mesh helpers: single-chip to multi-host, one code path.

The reference has no distributed layer at all (single process + two threads,
SURVEY.md §5). Here every multi-device feature is expressed against a
`jax.sharding.Mesh`; the same code runs on 1 chip (trivial mesh), a
multi-GPU host, or several hosts (after `init_multihost`).
Tests exercise it on a virtual 8-device CPU mesh
(xla_force_host_platform_device_count) and on two real OS processes
(tests/test_multiprocess.py spawns a 2-process jax.distributed cluster).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def landmark_mesh(n_devices: Optional[int] = None, axis: str = "lm") -> Mesh:
    """1-D mesh over (up to) all devices for landmark sharding."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def map_mesh(
    n_kf: int, n_lm: int, axes: Tuple[str, str] = ("kf", "lm")
) -> Mesh:
    """2-D mesh (keyframe blocks x landmark shards) for the 2-D distributed
    BA (parallel/dist_ba.make_dist_solver_2d): the "map blocks over the
    mesh" layout — keyframe blocks ride the first axis, landmark shards the
    second, so the per-iteration Wpl all_gather stays within a kf column."""
    devs = jax.devices()
    need = n_kf * n_lm
    if len(devs) < need:
        raise ValueError(
            f"map_mesh({n_kf}x{n_lm}) needs {need} devices, "
            f"have {len(devs)}")
    return Mesh(np.asarray(devs[:need]).reshape(n_kf, n_lm), axes)


def is_distributed_initialized() -> bool:
    try:
        return jax.distributed.is_initialized()
    except AttributeError:  # older jax
        from jax._src import distributed
        return distributed.global_state.client is not None


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-process JAX (idempotent).

    Three launch modes:
      * single host: call with no args — no-op.
      * managed launcher (SLURM, ...): call with no args
        AFTER the launcher exported the cluster env; jax.distributed
        auto-detects. We only auto-initialize when such env is present.
      * manual cluster: pass coordinator "host:port" plus num_processes
        and process_id explicitly (tests/test_multiprocess.py does this
        across two OS processes).
    """
    if is_distributed_initialized():
        return
    if coordinator is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
        return
    import os
    # Auto-init ONLY on actual multi-process evidence. SLURM_JOB_ID alone
    # is not evidence: a 1-task dev shell inside any SLURM allocation would
    # otherwise attempt cluster auto-detection and hang waiting for a
    # coordinator, where this function promises a single-host no-op.
    env = os.environ

    def _int(k):
        try:
            return int(env.get(k, "0"))
        except ValueError:
            return 0

    multiproc = (
        "COORDINATOR_ADDRESS" in env
        or _int("SLURM_NTASKS") > 1
        or _int("SLURM_NPROCS") > 1
    )
    if multiproc:
        try:
            jax.distributed.initialize()
        except Exception as e:
            # fall back to single-process rather than crash a run whose
            # cluster env was merely inherited, not real
            import logging
            logging.getLogger("ya_vo_tpu.parallel").warning(
                "jax.distributed.initialize() failed (%s); continuing "
                "single-process", e)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
