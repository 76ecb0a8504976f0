"""Real multi-process jax.distributed test (round-1 VERDICT missing #5):
two OS processes form a cluster via parallel.mesh.init_multihost, build a
global mesh over their combined devices, and run the distributed BA psum
path across the process boundary.

The reference is strictly single-process (SURVEY.md §5, "Distributed
communication backend: absent"); this pins the framework's multi-HOST
story without a cluster — two local processes exercise the same
jax.distributed + shard_map code path several hosts use (coordination
service + cross-process collectives).

The worker subprocesses run pure-CPU JAX with 2 virtual devices each.
"""

import os
import socket
import subprocess
import sys
import textwrap

_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from ya_vo_tpu.parallel import mesh as mesh_lib

    pid = int(sys.argv[1])
    mesh_lib.init_multihost({coord!r}, num_processes=2, process_id=pid)

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()   # 2 local x 2 procs
    assert mesh_lib.is_distributed_initialized()

    # cross-process collective: psum over a 4-device mesh spanning procs
    m = mesh_lib.landmark_mesh()
    def body(x):
        return jax.lax.psum(jnp.sum(x), "lm")
    f = jax.jit(jax.shard_map(body, mesh=m, in_specs=P("lm"),
                              out_specs=P()))
    import numpy as np
    x = np.arange(16, dtype=np.float32)
    total = f(x)
    assert float(total) == float(x.sum()), total

    # the actual dist-BA path across the process boundary
    from ya_vo_tpu.parallel import dist_ba
    from ya_vo_tpu.parallel.scaling_bench import build_problem
    cam, prob = build_problem(L=512, W=4)
    solve = dist_ba.make_dist_solver(m, cam, iters=4)
    poses, lms, c0, c1 = solve(prob)
    assert float(c1) < float(c0)
    assert bool(jnp.all(jnp.isfinite(poses)))
    print(f"proc{{pid}} OK cost {{float(c0):.3f}}->{{float(c1):.3f}}")
""")


def test_two_process_cluster_psum_and_dist_ba(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo, coord=coord))

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
        assert f"proc{pid} OK" in out, out
