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
- ``serving``: a mesh server (``launch/serve.py``) on one mesh: rank 0
  serves rounds of requests (sync, LazyGreedy, after an idle spell past the
  control group's timeout, async, a session) and ``solve(mode="served" |
  "async", mesh=)`` on every rank, the other ranks follow;
- ``selection``: ``SubmodularSelector.selection_step`` on one mesh;
- ``dryrun_step``: the dry run's selection step (``launch/dryrun.py``'s
  ``build_selection_step``) on one mesh, over the job's kernel;
- ``training``: train steps on DTensors placed by ``param_shardings``,
  each step's collectives counted, the state saved sharded and restored
  onto other meshes, and a MoE layer at a model axis of 2
  (:func:`training`);
- ``die_rank``: that rank exits before its first collective;
- ``serve_dies``: after the cases, a second mesh server whose follower
  ``rank`` exits; every other rank records how it ended (``dies{r}.pt``).

Children import the port alone (no JAX, no JAX package):
tests/test_torch_isolation.py walks this file with the port.
"""
import datetime
import hashlib
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


def _spec(req: dict):
    from repro_torch.core import SelectionSpec

    z, ng = req.get("stops", (True, True))
    return SelectionSpec(req["fn"], req["budget"], req.get("optimizer", "NaiveGreedy"),
                         stopIfZeroGain=z, stopIfNegativeGain=ng, **req.get("params", {}))


def _response(resp) -> dict:
    return {"result": _as_numpy(resp.result), "degraded": resp.degraded,
            "n_bucket": resp.n_bucket, "wave_size": resp.wave_size}


def _raises(call) -> tuple | None:
    try:
        call()
    except Exception as e:  # the type and message are the test's to check
        return type(e).__name__, str(e)
    return None


def serving(sj: dict, mesh) -> dict:
    """The serving job: rank 0's rounds and sequential solves, every rank's
    control-plane counters and solve(mode=..., mesh=) results."""
    from repro_torch.core import FeatureBased, SelectionSpec, solve
    from repro_torch.launch.async_serve import AsyncSelectionServer
    from repro_torch.launch.resilience import BreakerBoard, RetryPolicy
    from repro_torch.launch.serve import SelectionServer

    specs = {name: [_spec(r) for r in reqs] for name, reqs in sj["rounds"].items()}
    h = hashlib.sha256()

    def digest(results):  # each mesh wave's whole batch, in wave order, on every rank
        for r in results:
            for t in (r.order, r.gains, r.n_evals, r.value):
                h.update(t.cpu().numpy().tobytes())

    server = SelectionServer(
        mesh=mesh, control_timeout=datetime.timedelta(seconds=sj["control_timeout_s"]),
        retry_policy=RetryPolicy(max_attempts=3, backoff_s=0.0, jitter=0.0),
        breakers=BreakerBoard(threshold=1), on_mesh_wave=digest)
    out = {}
    if server.is_follower:
        out["follower_submit"] = _raises(lambda: server.submit(specs["mixed"][0]))
        out["follower_flush"] = _raises(server.flush)
        front = AsyncSelectionServer(server)  # starts no flush thread on a follower
        out["follower_async_submit"] = _raises(lambda: front.submit(specs["mixed"][0]))
        front.close()
        out["followed"] = server.follow()
    else:
        try:
            rounds = {name: [_response(r) for r in server.select(specs[name])]
                      for name in ("mixed", "lazy")}
            time.sleep(sj["idle_s"])  # idle past the control group's timeout
            rounds["after_idle"] = [_response(r) for r in server.select(specs["after_idle"])]
            with AsyncSelectionServer(server, max_pending=sj["max_pending"],
                                      flush_interval=0.05) as front:
                futures = [front.submit(s) for s in specs["async"]]
                rounds["async"] = [_response(f.result(timeout=60)) for f in futures]
            f0, deltas, budget = sj["session"]
            session = server.open_session(
                SelectionSpec(FeatureBased.from_features(f0, concave="sqrt", device="cpu"),
                              budget))
            rounds["session"] = [_as_numpy(session.extend(features=x).result) for x in deltas]
            out["rounds"] = rounds
            out["sequential"] = {name: [_as_numpy(solve(s)) for s in specs[name]]
                                 for name in specs}
            out["stats"] = server.stats.summary()
        finally:
            server.close()
    out["mesh"], out["digest"] = server.mesh_stats, h.hexdigest()
    # the solve() routes: every rank makes the same call, each gets rank 0's results
    out["solve"] = {mode: [_as_numpy(r) for r in solve(specs["solve"], mode=mode, mesh=mesh)]
                    for mode in ("served", "async")}
    return out


def selection(sj: dict, mesh) -> dict:
    """``selection_step`` on every rank, as numpy (order, gains): on the
    selector's own kernel, and (``S``) on the kernel the job hands it."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.selection import SelectorConfig, SubmodularSelector

    sel = SubmodularSelector(get_config(sj["arch"]), SelectorConfig(**sj["config"]),
                             device="cpu")

    def step():
        order, gains = sel.selection_step(torch.tensor(sj["pool"]), mesh, sj["budget"])
        return order.numpy(), gains.numpy()

    out = {"own": step()}
    if "S" in sj:
        sel._kernel = lambda x, y=None: torch.tensor(sj["S"])
        out["given"] = step()
    return out


def dryrun_step(dj: dict, mesh) -> tuple:
    """The dry run's selection step of ``dj["variant"]`` over ``dj["S"]``
    (cast to bf16 for the bf16 variants) on every rank, as numpy (order,
    gains)."""
    from repro_torch.core.optimizers import _threefry
    from repro_torch.launch.dryrun import build_selection_step

    S = torch.tensor(dj["S"])
    fn, _, _ = build_selection_step(mesh, pool=S.shape[1], budget=dj["budget"],
                                    variant=dj["variant"])
    sim = S.bfloat16() if "bf16" in dj["variant"] else S
    args = (_threefry.prng_key(dj["seed"]),) if "stochastic" in dj["variant"] else ()
    order, gains = fn(sim, *args)
    return order.numpy(), gains.numpy()


def serve_dies(dj: dict, rank: int, d: Path) -> None:
    """A mesh server on a mesh of its own (short timeouts) whose follower
    ``dj["rank"]`` exits: rank 0's wave and every other follower must end
    typed (MeshFailed) within the timeouts."""
    from repro_torch.core import make_mesh
    from repro_torch.launch.mesh_plane import MeshFailed
    from repro_torch.launch.serve import SelectionServer

    timeout = datetime.timedelta(seconds=dj["timeout_s"])
    mesh = make_mesh((2, 2), ("batch", "data"), device="cpu", timeout=timeout)
    server = SelectionServer(mesh=mesh, control_timeout=timeout)
    if rank == dj["rank"]:
        os._exit(3)
    t0 = time.monotonic()
    out = {}
    try:
        if server.is_follower:
            server.follow()
            out["outcome"] = "returned"
        else:
            spec = _spec(dj["request"])
            server.select([spec])
            out["outcome"] = "served"
    except MeshFailed as e:
        out["outcome"], out["error"] = "MeshFailed", str(e)
    out["seconds"] = time.monotonic() - t0
    if not server.is_follower:
        out["later"] = _raises(lambda: server.submit(_spec(dj["request"])))
    torch.save(out, d / f"dies{rank}.pt")


def _full(tree) -> dict:
    """A tree of DTensors as whole tensors by leaf name (a collective)."""
    from repro_torch.tree import flatten_with_names

    return {n: t.full_tensor() if hasattr(t, "full_tensor") else t
            for n, t in flatten_with_names(tree)}


def training(tj: dict, meshes: dict) -> dict:
    """The sharded-training job.  Each case: ``steps`` train steps of
    ``cfg`` from ``seed`` on DTensors placed by ``param_shardings`` under
    ``policy``, inside ``activation_sharding``; its losses, every step's
    collectives as ``CostCounter`` counts them, and the final state whole.
    With ``ckpt``: the state saved sharded under ``ckpt`` (step 1) and
    restored onto each mesh named in ``restore_on``, whole-tensor equal and
    with the asked placements.  ``moe``: ``moe_ffn`` of a MoE layer on
    DTensors and on whole tensors inside the same context (the group count
    rounded to the same ``tp_size()``), and ``tp_size()`` there."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.distributed.act_sharding import activation_sharding, tp_size
    from repro_torch.distributed.sharding import (
        batch_specs, distribute, param_shardings, shardings_of,
    )
    from repro_torch.launch.dryrun import CostCounter
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import flatten_with_names, leaves_like

    out = {}
    for name, case in tj.get("cases", {}).items():
        mesh, cfg, policy = meshes[case["mesh"]], case["cfg"], case["policy"]
        state = init_train_state(cfg, seed=case["seed"], device="cpu")
        state = distribute(state, param_shardings(state, mesh, policy))
        step = make_train_step(cfg)
        losses, colls = [], []
        for batch in case["batches"]:
            batch = distribute(batch, shardings_of(batch, batch_specs(batch, mesh, policy=policy),
                                                   mesh))
            counter = CostCounter(memory=False)
            with activation_sharding(mesh, policy=policy), counter:
                state, metrics = step(state, batch)
            losses.append(metrics["loss"].full_tensor())
            colls.append(counter.collectives())
        res = {"losses": losses, "collectives": colls, "state": _full(state)}
        if case.get("ckpt"):
            checkpoint.save(case["ckpt"], 1, state)
            res["restored"] = {}
            for other in case["restore_on"]:
                want = param_shardings(state, meshes[other], policy)
                got, meta = checkpoint.restore(case["ckpt"], state, shardings=want)
                placed = all(t.device_mesh is m and tuple(t.placements) == tuple(p)
                             for t, (m, p) in zip((l for _, l in flatten_with_names(got)),
                                                  leaves_like(state, want)))
                whole = _full(got)
                res["restored"][other] = {
                    "placed": placed, "step": meta["step"],
                    "equal": all(torch.equal(whole[n], res["state"][n]) for n in whole)}
        out[name] = res
    if "moe" in tj:
        from repro_torch.models.moe import moe_ffn

        mj = tj["moe"]
        mesh, cfg = meshes[mj["mesh"]], mj["cfg"]
        params = {"moe": {k: torch.as_tensor(v) for k, v in mj["params"].items()}}
        x = torch.as_tensor(mj["x"])
        placed = distribute(params, param_shardings(params, mesh, "fsdp"))["moe"]
        xd = distribute({"x": x}, shardings_of({"x": x}, batch_specs({"x": x}, mesh), mesh))["x"]
        with activation_sharding(mesh, policy="fsdp"):
            out["moe"] = {"tp_size": tp_size(), "sharded": moe_ffn(cfg, placed, xd).full_tensor(),
                          "whole": moe_ffn(cfg, params["moe"], x)}
    return out


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
        if "serving" in job:
            out["serving"] = serving(job["serving"], meshes[job["serving"]["mesh"]])
        if "selection" in job:
            out["selection"] = selection(job["selection"], meshes[job["selection"]["mesh"]])
        if "dryrun_step" in job:
            out["dryrun_step"] = dryrun_step(job["dryrun_step"],
                                             meshes[job["dryrun_step"]["mesh"]])
        if "training" in job:
            out["training"] = training(job["training"], meshes)
        torch.save(out, d / f"result{rank}.pt")
        if "serve_dies" in job:
            serve_dies(job["serve_dies"], rank, d)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _run(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
