"""The dry run: per-device cost and memory of a training or serving step on
the production mesh, with no card and no data (the JAX package's
``launch/dryrun.py``).

For every applicable (arch x shape) cell, on the single-pod (16, 16) mesh
and the (2, 16, 16) multi-pod mesh:

    a fake process group of 256 or 512 ranks (``torch.distributed``'s
    ``"fake"`` backend: collectives complete without moving data), the
    production ``DeviceMesh`` on it (``launch/mesh.py``);
    the abstract train state (or parameters, batch and cache) as DTensors
    on the meta device (not fake tensors: DTensor works out a strided
    shard's offsets with tensors and reads them back, which a
    ``FakeTensorMode`` refuses), placed by ``param_specs`` / ``batch_specs``
    / ``cache_specs`` under the ``auto_policy``;
    the step run once at full width and full depth under
    ``activation_sharding``, inside a dispatch mode that counts this rank's
    local operations.

The JAX package reads its counts from the compiled SPMD program; here they
come from the local operations the DTensors run, so they follow the same
conventions:
- ``flops_per_device``: the local products' flops (``torch.utils.
  flop_counter``'s formulas: matmuls, batched matmuls), the layers'
  recompute in backward included;
- ``bytes_per_device``: each local operation's input and output bytes (views
  and collectives excluded);
- ``collectives``: result bytes by kind (an all-reduce's payload, an
  all-gather's gathered bytes, a reduce-scatter's kept shard), their
  ``total`` and ``counts``;
- ``memory``: the local bytes of the arguments and of the outputs, and as
  ``temp`` the peak of the bytes allocated while the step ran (outputs
  included: the port makes a new state rather than donating the old one).

The record also says, as ``tp_activations``, whether activations were split
over the model axis: False under ``dp``, and under ``fsdp`` where this
torch's DTensor cannot fold a split dim (``act_sharding.folds_split_dims``;
the parameters keep their placements and the MoE group count its rounding,
so the function is the same and only the layout, and so the counts, differ).

The JAX package's unrolled depth probes and its HLO parser have no job here:
the port's layer stacks are Python loops, so the counts see every layer.

Results land in a JSON per cell (the keys ``benchmarks/roofline.py``
reads).  Usage:

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
        --mesh single --out results/dryrun_torch [--device cpu]
    python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch

``--device`` is the mesh's device type (default the card; the meta tensors
never touch it).  The selection cells (``--arch selection``) are not
ported yet.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.configs.base import get_config
from repro_torch.distributed.act_sharding import activation_sharding, splits_activations
from repro_torch.distributed.sharding import (
    auto_policy,
    batch_specs,
    cache_specs,
    distribute,
    param_specs,
    shardings_of,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SHAPES, ShapeCell, cell_applicable, input_specs
from repro_torch.tree import tree_leaves

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
GPU_BYTES = 80e9  # one H100's memory


def _tensors(tree) -> list[torch.Tensor]:
    out = []
    for x in tree if isinstance(tree, (list, tuple)) else [tree]:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _in_fake_mode() -> bool:
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


class CostCounter(TorchDispatchMode):
    """Counts the local operations of DTensor programs: a DTensor operation
    passes through (``NotImplemented``) and comes back as the local
    operations and collectives it runs.  ``flops``, ``bytes``, the
    collectives' result ``coll_bytes`` and ``coll_counts`` by kind, and the
    ``peak`` of the bytes allocated while the mode was on."""

    def __init__(self, memory: bool = True):
        super().__init__()
        from torch.distributed._functional_collectives import AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._wrappers = (DTensor, AsyncCollectiveTensor)
        self._flops = flop_registry
        self.memory = memory
        self.flops = 0
        self.bytes = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.live = self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._wrappers) for t in types):
            return NotImplemented  # DTensor and funcol's wrapper desugar first
        out = func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types) or _in_fake_mode():
            return out  # DTensor's shape inference: global shapes, under a fake mode
        if func.is_view:
            return out
        ins, outs = _tensors(list(args) + list(kwargs.values())), _tensors(out)
        ns, _, name = func._schema.name.partition("::")
        if ns == "_c10d_functional":
            kind = _KINDS.get(name)
            if kind is not None:
                self.coll_counts[kind] += 1
                self.coll_bytes[kind] += sum(t.nbytes for t in outs)
        else:
            packet = func._overloadpacket
            if packet in self._flops:
                self.flops += int(self._flops[packet](*args, **kwargs, out_val=out))
            self.bytes += sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        if self.memory:
            seen = {id(t) for t in ins}
            for t in outs:
                if id(t) not in seen and t._base is None:
                    n = t.nbytes
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(t, self._free, n)
        return out

    def collectives(self) -> dict:
        out = dict(self.coll_bytes)
        out["total"] = sum(self.coll_bytes.values())
        out["counts"] = dict(self.coll_counts)
        return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0; torn down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs no process group: one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_bytes(tree) -> int:
    """The bytes of a tree's tensors on this rank (a DTensor's local block)."""
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def build_step(cfg, cell: ShapeCell, mesh, policy: str = "auto"):
    """(fn, args, policy) for the cell: ``args`` are DTensors on the meta
    device placed on ``mesh``; ``fn(*args)`` runs the step once."""
    from repro_torch.models.model import decode_step, init_cache, init_params, prefill
    from repro_torch.train.train_step import init_train_state, make_train_step

    if policy == "auto":
        policy = auto_policy(cfg.param_count())
    batch = input_specs(cfg, cell)
    batch = distribute(batch, shardings_of(batch, batch_specs(batch, mesh, policy=policy), mesh))

    if cell.kind == "train":
        state = init_train_state(cfg, abstract=True)
        state = distribute(state, shardings_of(state, param_specs(state, mesh, policy), mesh))
        return make_train_step(cfg), (state, batch), policy

    params = init_params(cfg, abstract=True)
    params = distribute(params, shardings_of(params, param_specs(params, mesh, policy), mesh))
    if cell.kind == "prefill":
        def step(params, batch):
            # the caches prefill fills, placed by the cache rules
            B = batch["tokens"].shape[0]
            caches = init_cache(cfg, B, cell.seq_len, batch["tokens"].device)
            caches = distribute(caches, shardings_of(
                caches, cache_specs(caches, mesh, B, cell.seq_len), mesh))
            return prefill(cfg, params, batch, max_len=cell.seq_len, caches=caches)

        return step, (params, batch), policy

    cache = init_cache(cfg, cell.global_batch, cell.seq_len, abstract=True)
    cache = distribute(cache, shardings_of(
        cache, cache_specs(cache, mesh, cell.global_batch, cell.seq_len), mesh))
    tokens = input_specs(cfg, cell)
    tokens = distribute(tokens, shardings_of(
        tokens, batch_specs(tokens, mesh, shard_batch=cell.global_batch > 1), mesh))["tokens"]

    def step(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens, cell.seq_len - 1)

    return step, (params, cache, tokens), policy


def trace_cell(cfg, cell: ShapeCell, mesh, policy: str = "auto") -> dict:
    """Run the cell's step once on meta DTensors over ``mesh`` and count it;
    returns the record's measured part."""
    fn, args, policy = build_step(cfg, cell, mesh, policy)
    counter = CostCounter()
    t0 = time.monotonic()
    with activation_sharding(mesh, policy=policy), counter:
        tp_activations = splits_activations()
        out = fn(*args)
    trace_s = time.monotonic() - t0
    return {
        "policy": policy,
        "tp_activations": tp_activations,
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_size_in_bytes": local_bytes(args),
            "output_size_in_bytes": local_bytes(out),
            "temp_size_in_bytes": counter.peak,
        },
        "flops_per_device": float(counter.flops),
        "bytes_per_device": float(counter.bytes),
        "collectives": counter.collectives(),
    }


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str | None = None,
             device=None) -> dict:
    """One cell on the production mesh of ``mesh_kind`` ("single" or
    "multi") over a fake world of its size; writes ``arch__shape__mesh.json``
    under ``out_dir`` when given."""
    if arch == "selection":
        raise NotImplementedError(
            "the dry run's selection cells are not ported yet (ROADMAP, queue 1: "
            "the fl_gains wrappers must first be custom ops with fake implementations)")
    multi = mesh_kind == "multi"
    cfg, cell = get_config(arch), SHAPES[shape]
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device=device)
        record = {
            "arch": arch,
            "shape": shape,
            "mesh": mesh_kind,
            "mesh_shape": list(mesh.shape),
            "n_devices": mesh.size(),
            **trace_cell(cfg, cell, mesh),
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count(),
        }
    temp = record["memory"]["temp_size_in_bytes"]
    need = record["memory"]["argument_size_in_bytes"] + temp
    print(json.dumps(record, indent=2))
    print(f"{arch} {shape} {mesh_kind}: arguments + temp {need / 1e9:.2f} GB per device, "
          f"{'fits' if need <= GPU_BYTES else 'does not fit'} an 80 GB card")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json"), "w") as f:
            json.dump(record, f, indent=2)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id(s), comma separated")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type: cuda (default) or cpu")
    args = ap.parse_args(argv)
    # DTensor warns at every two-step redistribution of a 2-D mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ALL_ARCHS for s in SHAPES if cell_applicable(a, s)]
    elif args.arch:
        cells = []
        for arch in args.arch.split(","):
            if arch == "selection" or args.shape:
                cells.append((arch, args.shape or "select_1m"))
            else:
                cells.extend((arch, s) for s in SHAPES if cell_applicable(arch, s))
    else:
        ap.error("--arch or --all required")

    failures = []
    for arch, shape in cells:
        for mk in meshes:
            path = os.path.join(args.out, f"{arch}__{shape}__{mk}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"skip existing {path}")
                continue
            try:
                run_cell(arch, shape, mk, args.out, device=args.device)
            except Exception as e:  # noqa: BLE001 - every failing cell is listed
                traceback.print_exc()
                failures.append((arch, shape, mk, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"dry-run OK: {len(cells) * len(meshes)} cells")


if __name__ == "__main__":
    main()
