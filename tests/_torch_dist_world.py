"""Spawned ``torch.distributed`` worlds for the port's distributed tests.

The parent (a pytest process) writes a job with ``torch.save`` and starts
``world`` copies of this file, ``python tests/_torch_dist_world.py DIR RANK
WORLD``.  Each joins a ``gloo`` world through a file store in DIR (no
network), with a process-group timeout, builds the job's meshes on the CPU,
runs its cases and saves what it got beside the job.  The parent waits
for them all with a join timeout of its own and kills them when it runs
out, so a rank that dies or hangs fails the test within seconds, never the
test run's clock.

A job is a dict:
- ``meshes``: name -> (shape, axis names), built with ``make_mesh``;
- ``waves``: cases run through ``BatchedEngine(fns, valid, mesh).run``,
  each beside the port's sequential ``solve`` of its members (on this rank);
  a case that raises on every rank records the exception instead;
- ``partition``: the partition greedies on one mesh;
- ``die_rank``: that rank exits before its first collective.

Children import the port alone (no JAX, no JAX package):
tests/test_torch_isolation.py walks this file with the port.
"""
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
PG_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 120


def start_world(job: dict, world: int, tmpdir) -> list:
    """Start ``world`` ranks on ``job``; returns their processes."""
    d = Path(tmpdir)
    torch.save(job, d / "job.pt")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    return [
        subprocess.Popen([sys.executable, __file__, str(d), str(r), str(world)], cwd=ROOT,
                         env=env, stdout=subprocess.DEVNULL,
                         stderr=open(d / f"rank{r}.err", "w"))
        for r in range(world)
    ]


def join_world(procs: list, tmpdir, timeout: float = JOIN_TIMEOUT_S) -> list:
    """Every rank's exit code and stderr tail once all have exited, killing
    them all when ``timeout`` runs out first (then raises)."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"the world did not finish within {timeout} s: killed")
    return [(p.returncode, (Path(tmpdir) / f"rank{r}.err").read_text()[-3000:])
            for r, p in enumerate(procs)]


def results(procs: list, tmpdir, timeout: float = JOIN_TIMEOUT_S) -> list:
    """Every rank's saved results; raises naming the ranks that failed."""
    codes = join_world(procs, tmpdir, timeout)
    bad = [f"rank {r}: exit {rc}\n{err}" for r, (rc, err) in enumerate(codes) if rc]
    if bad:
        raise AssertionError("\n".join(bad))
    return [torch.load(Path(tmpdir) / f"result{r}.pt", weights_only=False)
            for r in range(len(procs))]


def _as_numpy(res):
    from repro_torch.interop import result_to_numpy

    return result_to_numpy(res)


def _wave(case: dict, mesh) -> dict:
    from repro_torch.core import BatchedEngine, OptimizerSpec, SelectionSpec, solve

    opt = OptimizerSpec(case["optimizer"], **case.get("params", {}))
    stop_zero, stop_neg = case.get("stops", (True, True))
    try:
        engine = BatchedEngine(case["fns"], valid=case.get("valid"), mesh=mesh)
        got = engine.run(case["budgets"], opt, stop_if_zero=stop_zero, stop_if_negative=stop_neg)
    except (ValueError, TypeError, NotImplementedError) as e:
        return {"raised": (type(e).__name__, str(e))}
    seq = [solve(SelectionSpec(f, b, opt, stopIfZeroGain=stop_zero, stopIfNegativeGain=stop_neg))
           for f, b in zip(case.get("seq_fns", case["fns"]), case["budgets"])]
    return {"sharded": [_as_numpy(r) for r in got], "sequential": [_as_numpy(r) for r in seq]}


def partition(job: dict, mesh) -> dict:
    """The partition greedies on a ("data", "model") mesh, as numpy (order,
    gains): rows over model (also from a DTensor of this rank's block),
    rows replicated, columns over both dimensions in mesh order and
    reversed, the stochastic and the FLQMI greedy."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.core import (
        distributed_fl_greedy, distributed_flqmi_greedy, distributed_stochastic_fl_greedy,
    )
    from repro_torch.core.optimizers import _threefry

    S, budget = torch.tensor(job["S"]), job["budget"]
    data, model = mesh.get_coordinate()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    u, v = S.shape[0] // sizes["model"], S.shape[1] // sizes["data"]
    block = S[model * u : (model + 1) * u, data * v : (data + 1) * v].contiguous()
    out = {
        "fl": distributed_fl_greedy(S, budget, mesh),
        "fl_dtensor": distributed_fl_greedy(
            DTensor.from_local(block, mesh, [Shard(1), Shard(0)]), budget, mesh),
        "fl_cols": distributed_fl_greedy(S, budget, mesh, row_axes=None),
        "fl_cols4": distributed_fl_greedy(S, budget, mesh, row_axes=None,
                                          col_axes=("data", "model")),
        "fl_cols4_rev": distributed_fl_greedy(S, budget, mesh, row_axes=None,
                                              col_axes=("model", "data")),
        "stochastic": distributed_stochastic_fl_greedy(
            S, budget, mesh, _threefry.prng_key(job["seed"]), sample_per_shard=job["sample"]),
        "flqmi": distributed_flqmi_greedy(job["sim_qv"], job["modular"], budget, mesh),
    }
    return {k: (o.numpy(), g.numpy()) for k, (o, g) in out.items()}


def _run(d: Path, rank: int, world: int) -> None:
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import make_mesh

    torch.set_num_threads(1)
    job = torch.load(d / "job.pt", weights_only=False)
    timeout = datetime.timedelta(seconds=job.get("timeout_s", PG_TIMEOUT_S))
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}", rank=rank,
                            world_size=world, timeout=timeout)
    try:
        meshes = {name: make_mesh(shape, names, device="cpu", timeout=timeout)
                  for name, (shape, names) in job["meshes"].items()}
        if job.get("die_rank") == rank:
            os._exit(3)
        out = {name: _wave(case, meshes[case["mesh"]])
               for name, case in job.get("waves", {}).items()}
        if "partition" in job:
            out["partition"] = partition(job["partition"], meshes[job["partition"]["mesh"]])
        torch.save(out, d / f"result{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _run(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
