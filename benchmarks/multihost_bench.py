"""Multi-process (fake-cluster) BA throughput: 1 host vs 2 "hosts".

BASELINE.json asks for scaling measured at 1 chip / 1 host / N>=2
hosts. Real multi-host hardware is unreachable from this environment,
so the N>=2 leg runs the same fake cluster the multi-host tests use
(SURVEY.md S4): the SAME 8-device global mesh, either owned by one
process or split across two processes joined via
``jax.distributed.initialize`` (cross-process psum through gloo — the
DCN slot in the collective topology). The workload is the
landmark-sharded bundle adjustment, the only cross-device collective in
the system; the DP frontend has no cross-shard communication at all, so
its multi-host scaling is the single-host number (scaling_bench.py)
modulo host cores.

Both legs run 8 virtual devices on one 4-core machine, so absolute
iters/s is core-bound and NOISY; the number that matters is the ratio —
how much the process boundary (gloo DCN stand-in vs in-process ICI
stand-in) costs on an identical program.

Run: ``python benchmarks/multihost_bench.py [--nproc 2]``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

WORKER = r"""
import json, os, sys, time

sys.path.insert(0, os.environ["REPO_ROOT"])

import numpy as np
import jax
from sift_slam.utils.compile_cache import enable_compile_cache

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()

nproc = int(os.environ["NPROC"])
if nproc > 1:
    from sift_slam.parallel.multihost import (
        initialize_multihost,
    )
    initialize_multihost(
        coordinator_address=os.environ["COORD"],
        num_processes=nproc,
        process_id=int(os.environ["PID_IDX"]),
    )
assert len(jax.devices()) == 8, len(jax.devices())

from jax.sharding import PartitionSpec as P
from sift_slam.parallel.distributed import (
    distributed_bundle_adjust,
)
from sift_slam.parallel.multihost import (
    global_mesh, put_global, replicate_global,
)
from sift_slam.sfm.ba import BAState, Observations
from benchmarks.ba_bench import make_problem

mesh = global_mesh()
state, obs = make_problem(np.random.default_rng(0), 48, 32768, 512)
if nproc > 1:
    state = BAState(
        rotations=replicate_global(np.asarray(state.rotations), mesh),
        translations=replicate_global(np.asarray(state.translations), mesh),
        points=put_global(np.asarray(state.points), mesh, P("shard")),
        k_mat=replicate_global(np.asarray(state.k_mat), mesh),
    )
    obs = Observations(
        camera=replicate_global(np.asarray(obs.camera), mesh),
        landmark=replicate_global(np.asarray(obs.landmark), mesh),
        uv=replicate_global(np.asarray(obs.uv), mesh),
        valid=replicate_global(np.asarray(obs.valid), mesh),
    )

iters = 5
_, cost = distributed_bundle_adjust(state, obs, mesh, num_iterations=iters)
float(cost)  # sync (compile + warm-up)
reps = 3
t0 = time.perf_counter()
for _ in range(reps):
    _, cost = distributed_bundle_adjust(state, obs, mesh, num_iterations=iters)
    float(cost)
dt = (time.perf_counter() - t0) / reps
if jax.process_index() == 0:
    print("RESULT " + json.dumps(
        {"iters_per_s": round(iters / dt, 3), "cost": float(cost)}
    ), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_leg(repo: str, nproc: int) -> dict:
    port = _free_port()
    with tempfile.TemporaryDirectory() as td:
        worker_py = os.path.join(td, "worker.py")
        with open(worker_py, "w") as f:
            f.write(WORKER)
        procs = []
        for pid in range(nproc):
            env = dict(os.environ)
            env["JAX_PLATFORMS"] = "cpu"
            env["XLA_FLAGS"] = (
                f"--xla_force_host_platform_device_count={8 // nproc}"
            )
            env["REPO_ROOT"] = repo
            env["COORD"] = f"localhost:{port}"
            env["NPROC"] = str(nproc)
            env["PID_IDX"] = str(pid)
            procs.append(
                subprocess.Popen(
                    [sys.executable, worker_py],
                    env=env,
                    cwd=repo,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                )
            )
        outs = [p.communicate(timeout=1800)[0].decode() for p in procs]
        for p, out in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"worker failed:\n{out[-3000:]}")
        for line in outs[0].splitlines():
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
    raise RuntimeError("no RESULT line from process 0")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2)
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    one = _run_leg(repo, 1)
    multi = _run_leg(repo, args.nproc)
    # Identical optimization on both legs (same mesh, same problem).
    assert abs(one["cost"] - multi["cost"]) <= 1e-3 * max(1.0, one["cost"])
    print(
        json.dumps(
            {
                "ba_iters_per_s_1proc_8dev": one["iters_per_s"],
                f"ba_iters_per_s_{args.nproc}proc_8dev": multi["iters_per_s"],
                "process_boundary_retention": round(
                    multi["iters_per_s"] / one["iters_per_s"], 3
                ),
                "note": (
                    "same 8-device global mesh; >=2-process leg crosses "
                    "gloo (DCN stand-in); shared 4-core host -> ratio is "
                    "the signal, not absolute iters/s"
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
