"""Atomic checkpoints (the JAX package's ``ckpt/checkpoint.py`` on one
process): training state and the serving sessions' journal.

- Atomic: a step is written to ``<dir>.tmp`` and published with
  ``os.replace``, so a crash mid-save never corrupts a saved step.
- A step is one ``arrays.npz`` of the tree's leaves plus a ``manifest.json``
  (step, leaf names, shapes, dtypes and the caller's ``meta``).
- ``keep_last`` prunes old steps.

A tree is made of dicts, NamedTuples (a ``TrainState``), tuples and lists
(:mod:`repro_torch.tree`); its leaves are tensors on any device, numpy
arrays or scalars, named by their key path as the JAX package names them
(``.params/layers/attn/wq``).  numpy has no bfloat16: a bf16 tensor is
stored as its bits (``uint16``) with ``"bfloat16"`` in the manifest.
``restore`` gives a leaf whose counterpart in ``like`` is a tensor back as a
tensor in its saved dtype on that counterpart's device; any other leaf
comes back as numpy.  The sharded save and the
elastic restore onto another mesh are ROADMAP item 12.5.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten_with_names, unflatten_by_name

__all__ = ["save", "restore", "latest_step"]

_BF16 = "bfloat16"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, like):
    if not isinstance(like, torch.Tensor):
        return arr
    t = torch.from_numpy(np.array(arr))  # a writable copy; keeps a 0-d shape
    if dtype == _BF16:
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(like.device)


def save(ckpt_dir: str, step: int, tree: Any, meta: dict | None = None,
         keep_last: int = 3) -> str:
    """Save ``tree`` as step ``step`` under ``ckpt_dir`` atomically; returns
    the step's directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "leaves": [], "meta": meta or {}}
    for name, leaf in flatten_with_names(tree):
        arr, dtype = _to_numpy(leaf)
        key = name.replace("/", "__")
        arrays[key] = arr
        manifest["leaves"].append(
            {"name": name, "key": key, "shape": list(arr.shape), "dtype": dtype}
        )
    np.savez(os.path.join(tmp_dir, "arrays.npz"), **arrays)
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)  # atomic publish
    _prune(ckpt_dir, keep_last)
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


def restore(ckpt_dir: str, like: Any, step: int | None = None) -> tuple[Any, dict]:
    """Restore step ``step`` (default: the latest) into the structure of
    ``like``; returns ``(tree, meta)``, ``meta`` holding the saved meta and
    the step."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {entry["name"]: entry for entry in manifest["leaves"]}
    values = {}
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        for name, leaf in flatten_with_names(like):
            entry = by_name[name]
            values[name] = _from_numpy(data[entry["key"]], entry["dtype"], leaf)
    return unflatten_by_name(like, values), manifest["meta"] | {"step": manifest["step"]}
