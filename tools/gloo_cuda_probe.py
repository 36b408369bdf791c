"""Which collectives four gloo ranks on one card can run on CUDA tensors.

Each case runs in a world of its own, four ranks of this script over a file
store with a 60 s process-group timeout, so a case that crashes a rank
(SIGSEGV) ends only its own world; the parent prints one JSON line per case
with the ranks' exit codes and rank 0's result or error.  It imports torch
only.

    python tools/gloo_cuda_probe.py                # every case
    python tools/gloo_cuda_probe.py funcol_all_gather,dtensor_shard_to_replicate
"""
import datetime
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def _case(name: str, rank: int):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dev = torch.device("cuda", 0)
    x = torch.arange(8.0, device=dev) + rank
    world = dist.group.WORLD
    if name == "all_reduce":
        dist.all_reduce(y := x.clone())
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(y := torch.empty(32, device=dev), x)
    elif name == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(y := torch.empty(2, device=dev), x)
    elif name == "all_to_all_single":
        dist.all_to_all_single(y := torch.empty(8, device=dev), x)
    elif name == "funcol_all_gather":
        y = funcol.all_gather_tensor(x, 0, world) + 0
    elif name == "funcol_all_gather_mesh_dim":
        y = funcol.all_gather_tensor(x, 0, init_device_mesh("cuda", (2, 2)).get_group(0)) + 0
    elif name == "funcol_reduce_scatter":
        y = funcol.reduce_scatter_tensor(x, "sum", 0, world) + 0
    elif name == "funcol_all_to_all":
        y = funcol.all_to_all_single(x, None, None, world) + 0
    else:
        mesh = init_device_mesh("cuda", (2, 2))
        start = {"dtensor_shard_to_replicate": [Shard(0), Shard(1)],
                 "dtensor_partial_to_shard": [Partial(), Partial()],
                 "dtensor_shard0_to_shard1": [Shard(0), Shard(1)]}[name]
        end = {"dtensor_shard_to_replicate": [Replicate(), Replicate()],
               "dtensor_partial_to_shard": [Shard(0), Shard(1)],
               "dtensor_shard0_to_shard1": [Shard(1), Shard(0)]}[name]
        t = DTensor.from_local(torch.randn(4, 6, device=dev), mesh, start, run_check=False)
        y = t.redistribute(mesh, end).to_local()
    torch.cuda.synchronize()
    return y.flatten()[:4].tolist()


CASES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
         "funcol_all_gather", "funcol_all_gather_mesh_dim", "funcol_reduce_scatter",
         "funcol_all_to_all", "dtensor_shard_to_replicate", "dtensor_partial_to_shard",
         "dtensor_shard0_to_shard1")


def _rank(name: str, rank: int, d: Path) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}", rank=rank,
                            world_size=4, timeout=datetime.timedelta(seconds=60))
    try:
        out = {"ok": _case(name, rank)}
    except Exception as e:  # the error is the probe's result
        out = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
    (d / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def main(names) -> None:
    import torch

    print(json.dumps({"torch": torch.__version__, "device": torch.cuda.get_device_name(0)}))
    for name in names:
        d = Path(tempfile.mkdtemp())
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", name, str(r), str(d)],
                                  stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                 for r in range(4)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, 120 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
        codes = [p.wait() for p in procs]
        f = d / "rank0.json"
        print(json.dumps({"case": name, "exit_codes": codes,
                          "rank0": json.loads(f.read_text()) if f.exists() else None,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank(sys.argv[2], int(sys.argv[3]), Path(sys.argv[4]))
    else:
        main(sys.argv[1].split(",") if len(sys.argv) > 1 else CASES)
