"""Atomic checkpoints of numpy payloads: the part of the JAX package's
``ckpt/checkpoint.py`` that the serving sessions' journal rides.

- Atomic: a step is written to ``<dir>.tmp`` and published with
  ``os.replace``, so a crash mid-save never corrupts a saved step.
- A step is one ``arrays.npz`` of the tree's leaves plus a ``manifest.json``
  (step, leaf names, shapes, dtypes and the caller's ``meta``).
- ``keep_last`` prunes old steps.

A tree is a leaf (anything ``np.asarray`` takes: numpy arrays, scalars,
CPU tensors) or a dict of trees; leaves are named by their key path.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np

__all__ = ["save", "restore", "latest_step"]


def _flatten_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree, key=str):
            name = f"{prefix}/{k}" if prefix else str(k)
            out.extend(_flatten_with_names(tree[k], name))
        return out
    return [(prefix, tree)]


def _unflatten(like, values: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {
            k: _unflatten(like[k], values, f"{prefix}/{k}" if prefix else str(k)) for k in like
        }
    return values[prefix]


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
    for name, leaf in _flatten_with_names(tree):
        arr = np.asarray(leaf)
        key = name.replace("/", "__")
        arrays[key] = arr
        manifest["leaves"].append(
            {"name": name, "key": key, "shape": list(arr.shape), "dtype": str(arr.dtype)}
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
    ``like``; returns ``(tree, meta)`` with numpy leaves, ``meta`` holding
    the saved meta and the step."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        values = {entry["name"]: data[entry["key"]] for entry in manifest["leaves"]}
    return _unflatten(like, values), manifest["meta"] | {"step": manifest["step"]}
