"""Fault-tolerant checkpoints (the JAX package's ``ckpt/checkpoint.py``):
training state and the serving sessions' journal.

- Atomic: a step is written to ``<dir>.tmp`` and published with
  ``os.replace``, so a crash mid-save never corrupts a saved step.
- Sharded: each rank writes one ``shard_{rank:05d}.npz`` of the blocks it
  holds, plus rank 0 a ``manifest.json`` (step, leaf names, global shapes,
  dtypes, every block's rank and offset, and the caller's ``meta``).  A
  DTensor leaf's block is written once, by the rank at coordinate 0 of
  each mesh dim it is replicated over; a plain leaf is written whole by
  rank 0.  A tree with no DTensor is saved by the calling process alone,
  as ``shard_00000.npz``; a tree with DTensors is a collective call of
  every rank of the default process group (barriers before the publish
  and after it).
- Elastic restore: ``restore(..., shardings=)`` rebuilds each leaf as a
  DTensor on the given ``(mesh, placements)``, each rank reading the saved
  blocks that overlap its own, whatever mesh and world size saved them.
- ``keep_last`` prunes old steps (rank 0).

A tree is made of dicts, NamedTuples (a ``TrainState``), tuples and lists
(:mod:`repro_torch.tree`); its leaves are tensors or DTensors on any
device, numpy arrays or scalars, named by their key path as the JAX package
names them (``.params/layers/attn/wq``).  numpy has no bfloat16: a bf16
tensor is stored as its bits (``uint16``) with ``"bfloat16"`` in the
manifest.  Without ``shardings``, ``restore`` gives a leaf whose counterpart
in ``like`` is a tensor back whole, as a tensor in its saved dtype on that
counterpart's device; any other leaf comes back as numpy.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import flatten_with_names, leaves_like, unflatten_by_name

__all__ = ["save", "restore", "latest_step"]

_BF16 = "bfloat16"


def _to_numpy(leaf) -> np.ndarray:
    """The array to store: a bf16 tensor as its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _shape(leaf) -> list:
    return list(leaf.shape) if isinstance(leaf, torch.Tensor) else list(np.shape(leaf))


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))  # a writable copy; keeps a 0-d shape
    if dtype == _BF16:
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _blocks(leaf) -> list[tuple[int, list, list]]:
    """(rank, offset, shape) of each block a leaf is saved in: a DTensor's
    distinct shards, by the rank at coordinate 0 of every dim it is not
    split over; anything else one whole block of rank 0."""
    if not _is_dtensor(leaf):
        return [(0, [0] * len(_shape(leaf)), _shape(leaf))]
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.sharding import local_box

    mesh, pl = leaf.device_mesh, leaf.placements
    ranges = [range(mesh.size(d)) if isinstance(p, Shard) else range(1)
              for d, p in enumerate(pl)]
    out = []
    for coord in itertools.product(*ranges):
        shape, off = local_box(leaf.shape, mesh, pl, coord)
        out.append((int(mesh.mesh[coord].item()), list(off), list(shape)))
    return out


def save(ckpt_dir: str, step: int, tree: Any, meta: dict | None = None,
         keep_last: int = 3) -> str:
    """Save ``tree`` as step ``step`` under ``ckpt_dir`` atomically; returns
    the step's directory."""
    leaves = flatten_with_names(tree)
    sharded = any(_is_dtensor(leaf) for _, leaf in leaves)
    rank = dist.get_rank() if sharded else 0
    barrier = dist.barrier if sharded else (lambda: None)
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp_dir = step_dir + ".tmp"
    if rank == 0:
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir, exist_ok=True)
    barrier()

    arrays = {}
    manifest = {"step": step, "leaves": [], "meta": meta or {}}
    for name, leaf in leaves:
        key = name.replace("/", "__")
        blocks = _blocks(leaf)
        if any(r == rank for r, _, _ in blocks):
            arrays[key] = _to_numpy(leaf.to_local() if _is_dtensor(leaf) else leaf)
        manifest["leaves"].append({
            "name": name, "key": key, "shape": _shape(leaf), "dtype": _dtype_name(leaf),
            "blocks": [{"rank": r, "offset": o, "shape": s} for r, o, s in blocks],
        })
    np.savez(os.path.join(tmp_dir, f"shard_{rank:05d}.npz"), **arrays)
    barrier()
    if rank == 0:
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.replace(tmp_dir, step_dir)  # atomic publish
        _prune(ckpt_dir, keep_last)
    barrier()
    return step_dir


def _prune(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


class _Shards:
    """The step's ``shard_*.npz`` files, each opened once when first read."""

    def __init__(self, step_dir: str):
        self.step_dir, self.files = step_dir, {}

    def get(self, rank: int, key: str) -> np.ndarray:
        if rank not in self.files:
            self.files[rank] = np.load(os.path.join(self.step_dir, f"shard_{rank:05d}.npz"))
        return self.files[rank][key]

    def close(self) -> None:
        for f in self.files.values():
            f.close()


def _read_box(shards: _Shards, entry: dict, offset, shape) -> np.ndarray:
    """The saved leaf's values in the box at ``offset`` of ``shape``,
    assembled from every saved block that overlaps it."""
    blocks = entry["blocks"]
    if len(blocks) == 1 and list(shape) == entry["shape"]:
        return shards.get(blocks[0]["rank"], entry["key"])
    out = None
    for b in blocks:
        lo = [max(o, bo) for o, bo in zip(offset, b["offset"])]
        hi = [min(o + n, bo + bn) for o, n, bo, bn in zip(offset, shape, b["offset"], b["shape"])]
        if any(h <= l_ for l_, h in zip(lo, hi)):
            continue
        src = shards.get(b["rank"], entry["key"])
        if out is None:
            out = np.empty(shape, dtype=src.dtype)
        out[tuple(slice(l_ - o, h - o) for l_, h, o in zip(lo, hi, offset))] = \
            src[tuple(slice(l_ - bo, h - bo) for l_, h, bo in zip(lo, hi, b["offset"]))]
    if out is None:  # an empty box
        out = np.empty(shape, dtype=shards.get(blocks[0]["rank"], entry["key"]).dtype)
    return out


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore(ckpt_dir: str, like: Any, step: int | None = None,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore step ``step`` (default: the latest) into the structure of
    ``like``; returns ``(tree, meta)``, ``meta`` holding the saved meta and
    the step.  ``shardings`` (a tree of ``(mesh, placements)`` of ``like``'s
    structure, e.g. ``sharding.param_shardings``) places each leaf as a
    DTensor on its mesh: the elastic restart, onto any mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import contiguous_stride, local_box

    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {entry["name"]: entry for entry in manifest["leaves"]}
    names_like = flatten_with_names(like)
    placed = leaves_like(like, shardings) if shardings is not None else [None] * len(names_like)
    shards = _Shards(step_dir)
    values = {}
    try:
        for (name, leaf), where in zip(names_like, placed):
            entry = by_name[name]
            if where is None:
                arr = _read_box(shards, entry, [0] * len(entry["shape"]), entry["shape"])
                values[name] = (_to_tensor(arr, entry["dtype"], leaf.device)
                                if isinstance(leaf, torch.Tensor) else arr)
                continue
            mesh, pl = where
            shape, off = local_box(entry["shape"], mesh, pl)
            local = _to_tensor(_read_box(shards, entry, off, shape), entry["dtype"],
                               _mesh_device(mesh))
            values[name] = DTensor.from_local(local, mesh, pl, run_check=False,
                                              shape=torch.Size(entry["shape"]),
                                              stride=contiguous_stride(entry["shape"]))
    finally:
        shards.close()
    return unflatten_by_name(like, values), manifest["meta"] | {"step": manifest["step"]}
