"""The dry run: per-device cost and memory of a training or serving step,
or of the paper's selection step, on the production mesh, with no card and
no data (the JAX package's ``launch/dryrun.py``).

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

The selection cells (``--arch selection``, shapes ``select_1m``,
``select_1m_stoch``, ``select_1m_bf16``, ``select_1m_stoch_bf16``) trace
:func:`build_selection_step`'s step: ``distributed_fl_greedy`` or
``distributed_stochastic_fl_greedy`` (budget 512) over a (16,384 x 2^20)
fp32 or bf16 kernel, a meta DTensor with its rows over ``"model"`` and its
columns over the data axes.  Its sweeps are the registered operators
``torch.ops.repro_torch.fl_gains`` / ``fl_gains_at`` (``kernels/ops.py``),
whose fake implementations run here; its collectives are
``torch.distributed``'s (``c10d::allreduce_``), not the functional ones.

The JAX package reads its counts from the compiled SPMD program; here they
come from the local operations the DTensors run, so they follow the same
conventions:
- ``flops_per_device``: the local products' flops (``torch.utils.
  flop_counter``'s formulas: matmuls, batched matmuls), the layers'
  recompute in backward included; the FL sweeps are no products, so they
  add none;
- ``bytes_per_device``: each local operation's input and output bytes (views
  and collectives excluded); a gather's (``index_select``, ``gather``,
  ``index``, ``embedding``) are its output read and written and its indices,
  not its whole source, as XLA's cost analysis counts a gather; a
  registered kernel operator's are what its kernel reads and writes
  (``ops.OP_BYTES``: the gathered sweep reads its k columns, not the whole
  block), counted as element bytes: k random columns of a row-major block
  move about one 32-byte sector an element on the card, 8x (fp32) to 16x
  (bf16) the count, so the dense variants' ~64x the stochastic ones' FL
  bytes is the JAX package's count, not the ratio of the traffic;
- ``collectives``: result bytes by kind (an all-reduce's payload, an
  all-gather's gathered bytes, a reduce-scatter's kept shard), their
  ``total`` and ``counts``, the functional collectives' and
  ``torch.distributed``'s alike, each counted once (a broadcast has no kind
  in the JAX package's record, and no traced step runs one);
- ``memory``: the local bytes of the arguments and of the outputs, and as
  ``temp`` the peak of the bytes allocated while the step ran (outputs
  included: the port makes a new state rather than donating the old one).

The record also says, as ``tp_activations``, whether activations were split
over the model axis (``act_sharding.splits_activations``): under ``fsdp`` on
a model axis of more than one rank, not under ``dp``, on every torch (the
products over split dims run on each rank's blocks, ``local_blocks``).

The JAX package's unrolled depth probes and its HLO parser have no job here:
the port's layer stacks are Python loops, so the counts see every layer.

Results land in a JSON per cell (the keys ``benchmarks/roofline.py``
reads).  Usage:

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
        --mesh single --out results/dryrun_torch [--device cpu]
    python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch

``--device`` is the mesh's device type (default the card; the meta tensors
never touch it).  ``--arch selection`` takes ``--shape`` (default
``select_1m``); ``--all`` adds ``select_1m``, as the JAX package does.  The
selection records carry the JAX package's selection keys, ``trace_s`` for
its compile times, ``bytes_per_device`` / ``flops_per_device``, and
``kernel_bytes``: the FL operators' bytes by operator.
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
    contiguous_stride,
    data_axes,
    distribute,
    local_box,
    param_specs,
    shardings_of,
    to_placements,
)
from repro_torch.kernels.ops import OP_BYTES
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
# torch.distributed's own collectives, as they reach the dispatcher
_C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}
# gathers: their output's bytes read and written and their indices (every
# input after the first), not the whole source
_GATHERS = {"index_select", "gather", "index", "embedding"}
# the selection cells' shapes and their variants of build_selection_step
SELECTION_SHAPES = {
    "select_1m": "dense",
    "select_1m_stoch": "stochastic",
    "select_1m_bf16": "bf16",
    "select_1m_stoch_bf16": "stochastic_bf16",
}
SELECTION_ROWS = 1 << 14  # the represented-set subsample (rows); the columns are the pool
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
    operations and collectives it runs.  ``flops``, ``bytes`` (of which
    ``kernel_bytes`` by registered kernel operator), the collectives' result
    ``coll_bytes`` and ``coll_counts`` by kind, and the ``peak`` of the
    bytes allocated while the mode was on."""

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
        self.kernel_bytes: dict[str, int] = {}  # by registered kernel operator
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
        if ns in ("_c10d_functional", "c10d"):
            kind = (_KINDS if ns == "_c10d_functional" else _C10D_KINDS).get(name)
            if kind is not None:
                self.coll_counts[kind] += 1
                self.coll_bytes[kind] += sum(t.nbytes for t in outs)
        elif ns == "repro_torch":
            n = OP_BYTES[name](*args, **kwargs)
            self.bytes += n
            self.kernel_bytes[name] = self.kernel_bytes.get(name, 0) + n
        elif ns == "aten" and name in _GATHERS:
            self.bytes += 2 * sum(t.nbytes for t in outs) + sum(t.nbytes for t in ins[1:])
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


def build_selection_step(mesh, pool: int = 1 << 20, dim: int = 1024, budget: int = 512,
                         variant: str = "dense"):
    """(fn, args, policy) of the paper's technique on ``mesh``: the
    distributed FL greedy over a (``SELECTION_ROWS`` x ``pool``) kernel, a
    meta DTensor with its rows over ``"model"`` and its columns over
    ``data_axes(mesh)``.  Variants (the JAX package's): ``dense`` (fp32,
    every column swept each step), ``stochastic`` (1,024 sampled columns a
    shard and step, ``args`` ending in a ``_threefry.prng_key``), ``bf16``
    and ``stochastic_bf16`` (the kernel stored in bf16).  ``fn`` takes real
    tensors too: a (rows, pool) tensor or DTensor so placed, any size.
    ``dim`` (the embeddings' width) is the JAX package's argument and sizes
    nothing here."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.optimizers import _threefry
    from repro_torch.core.optimizers.distributed import (
        distributed_fl_greedy,
        distributed_stochastic_fl_greedy,
    )

    if variant not in SELECTION_SHAPES.values():
        raise ValueError(f"unknown selection variant {variant!r}; "
                         f"choose from {tuple(SELECTION_SHAPES.values())}")
    dp = data_axes(mesh)
    shape = (SELECTION_ROWS, pool)
    placements = to_placements(("model", dp), mesh)
    local = torch.empty(local_box(shape, mesh, placements)[0], device="meta",
                        dtype=torch.bfloat16 if "bf16" in variant else torch.float32)
    sim = DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                             stride=contiguous_stride(shape))
    if "stochastic" in variant:
        def step(sim, key):
            return distributed_stochastic_fl_greedy(sim, budget, mesh, key, sample_per_shard=1024,
                                                    row_axes=("model",), col_axes=dp)

        return step, (sim, _threefry.prng_key(0)), "fsdp"

    def step(sim):
        return distributed_fl_greedy(sim, budget, mesh, row_axes=("model",), col_axes=dp)

    return step, (sim,), "fsdp"


def _count(fn, args, policy: str, context, counter: CostCounter) -> dict:
    """Run ``fn(*args)`` once under ``context`` and ``counter``; the
    record's measured part."""
    t0 = time.monotonic()
    with context, counter:
        out = fn(*args)
    return {
        "policy": policy,
        "trace_s": round(time.monotonic() - t0, 2),
        "memory": {
            "argument_size_in_bytes": local_bytes(args),
            "output_size_in_bytes": local_bytes(out),
            "temp_size_in_bytes": counter.peak,
        },
        "flops_per_device": float(counter.flops),
        "bytes_per_device": float(counter.bytes),
        "collectives": counter.collectives(),
    }


def trace_cell(cfg, cell: ShapeCell, mesh, policy: str = "auto") -> dict:
    """Run the cell's step once on meta DTensors over ``mesh`` and count it;
    returns the record's measured part."""
    fn, args, policy = build_step(cfg, cell, mesh, policy)
    regime = {}

    def step(*args):
        regime["tp_activations"] = splits_activations()
        return fn(*args)

    record = _count(step, args, policy, activation_sharding(mesh, policy=policy),
                    CostCounter())
    return {**regime, **record}


def trace_selection(mesh, variant: str = "dense", **kw) -> dict:
    """Run :func:`build_selection_step`'s step once over ``mesh`` and count
    it; returns the record's measured part, with ``kernel_bytes``, the FL
    operators' share of ``bytes_per_device``.  ``kw`` as for that
    function."""
    fn, args, policy = build_selection_step(mesh, variant=variant, **kw)
    counter = CostCounter()
    record = _count(fn, args, policy, contextlib.nullcontext(), counter)
    return {**record, "kernel_bytes": dict(counter.kernel_bytes)}


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str | None = None,
             device=None) -> dict:
    """One cell on the production mesh of ``mesh_kind`` ("single" or
    "multi") over a fake world of its size; writes
    ``arch__shape__mesh.json`` under ``out_dir`` when given.  ``arch``
    "selection" takes a shape of :data:`SELECTION_SHAPES`."""
    multi = mesh_kind == "multi"
    if arch == "selection" and shape not in SELECTION_SHAPES:
        raise ValueError(f"unknown selection shape {shape!r}; choose from "
                         f"{tuple(SELECTION_SHAPES)}")
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device=device)
        record = {
            "arch": arch,
            "shape": shape,
            "mesh": mesh_kind,
            "mesh_shape": list(mesh.shape),
            "n_devices": mesh.size(),
        }
        if arch == "selection":
            record.update(trace_selection(mesh, SELECTION_SHAPES[shape]))
        else:
            cfg = get_config(arch)
            record.update(trace_cell(cfg, SHAPES[shape], mesh),
                          params_total=cfg.param_count(),
                          params_active=cfg.active_param_count())
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


def cells_of(all_cells: bool, arch: str | None, shape: str | None) -> list[tuple[str, str]]:
    """The CLI's (arch, shape) cells: ``--all``'s every applicable cell and
    ``select_1m``, or ``--arch``'s (comma separated) at ``--shape``, else at
    every applicable shape (``select_1m`` for ``selection``)."""
    if all_cells:
        return [(a, s) for a in ALL_ARCHS for s in SHAPES if cell_applicable(a, s)] + [
            ("selection", "select_1m")]
    cells = []
    for a in arch.split(","):
        if a == "selection" or shape:
            cells.append((a, shape or "select_1m"))
        else:
            cells.extend((a, s) for s in SHAPES if cell_applicable(a, s))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="arch id(s), comma separated, or 'selection'")
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
    if not (args.all or args.arch):
        ap.error("--arch or --all required")
    cells = cells_of(args.all, args.arch, args.shape)

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
