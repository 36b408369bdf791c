"""Per-architecture sharding rules (the JAX package's
``distributed/sharding.py``), on ``DeviceMesh`` placements.

2-D sharding: a weight's input dim shards over the data axes (FSDP / ZeRO-3
storage) and its output dim over ``"model"`` (Megatron TP); experts shard
over ``"model"`` (EP).  Rules are keyed on the leaf's name in the tree
(:func:`repro_torch.tree.flatten_with_names`, ``.params/layers/attn/wq``);
stacked layer dims get leading ``None``s.  An axis that does not divide its
dim is dropped (:func:`filter_divisible`), as the JAX package drops it.

A spec is a plain tuple with one entry per tensor dim, in the JAX idiom:
``None``, an axis name, or a tuple of names (``("pod", "data")``).
:func:`to_placements` turns it into one ``Placement`` per mesh dim.

``dp`` below is ``"data"`` on the single-pod mesh and ``("pod", "data")`` on
the multi-pod mesh: the pod axis widens the FSDP / batch sharding.

Only ``mesh.mesh_dim_names`` and ``mesh.size(dim)`` are read, so any object
with those two (a stub of a 256-rank mesh) can stand in for a mesh.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import flatten_with_names, unflatten_by_name

TP = "model"

__all__ = [
    "TP", "data_axes", "axis_size", "filter_divisible", "to_placements", "DP_POLICY_MAX_BYTES",
    "auto_policy", "param_specs", "param_shardings", "shardings_of", "batch_specs",
    "cache_specs", "local_box", "distribute",
]


def data_axes(mesh) -> tuple[str, ...]:
    """The dimension names of ``mesh`` among ``("pod", "data")``, in mesh
    order."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _dp(mesh):
    """The data axes as one spec entry: a name, a tuple of names or None."""
    dp = data_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def _size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def _param_rules(dp) -> dict[str, tuple]:
    return {
        # embeddings / heads
        "embed": (TP, dp),
        "lm_head": (dp, TP),
        "patch_proj": (dp, TP),
        # attention (GQA)
        "wq": (dp, TP),
        "wk": (dp, TP),
        "wv": (dp, TP),
        "wo": (TP, dp),
        "bq": (TP,),
        "bk": (TP,),
        "bv": (TP,),
        "bo": (None,),
        # attention (MLA)
        "w_dkv": (dp, None),
        "w_krope": (dp, None),
        "w_dq": (dp, None),
        "w_uq": (None, TP, None),
        "w_uk": (None, TP, None),
        "w_uv": (None, TP, None),
        # ffn
        "w_gate": (dp, TP),
        "w_up": (dp, TP),
        "w_down": (TP, dp),
        "w_in": (dp, TP),
        "w_out": (TP, dp),
        "b_in": (TP,),
        "b_out": (None,),
        # moe
        "router": (dp, None),
        "shared_gate": (dp, TP),
        "shared_up": (dp, TP),
        "shared_down": (TP, dp),
        # mamba
        "in_proj": (dp, TP),
        "conv_w": (None, TP),
        "out_proj": (TP, dp),
        "dt_bias": (TP,),
        "A_log": (TP,),
        "D": (TP,),
        "norm": (TP,),
    }


_MOE_EXPERT_RULES = {
    # experts: EP over model, FSDP over data on the d_model dim
    "w_gate": lambda dp: (TP, dp, None),
    "w_up": lambda dp: (TP, dp, None),
    "w_down": lambda dp: (TP, None, dp),
}


def wo_mla(dp) -> tuple:
    """MLA's output projection, (H, hd, D)."""
    return (TP, None, dp)


def axis_size(mesh, entry) -> int:
    """The number of shards a spec entry makes on ``mesh``."""
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= _size(mesh, a)
        return n
    return _size(mesh, entry)


def filter_divisible(spec: tuple, shape, mesh) -> tuple:
    """``spec`` with every entry whose axes do not divide its dim dropped."""
    return tuple(
        None if entry is not None and shape[i] % axis_size(mesh, entry) else entry
        for i, entry in enumerate(spec)
    )


def to_placements(spec: tuple, mesh) -> list:
    """One placement per mesh dim: ``Shard(i)`` where the dim's name is (or
    is in) entry ``i`` of ``spec`` and the dim holds more than one rank,
    else ``Replicate()``.  A tensor dim that
    names several mesh dims is split over them in mesh order (major to
    minor, as in JAX)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for d, name in enumerate(mesh.mesh_dim_names):
        dim = next((i for i, e in enumerate(spec)
                    if e == name or (isinstance(e, (tuple, list)) and name in e)), None)
        # a mesh dim of one rank splits nothing: it replicates
        out.append(Replicate() if dim is None or mesh.size(d) == 1 else Shard(dim))
    return out


def local_box(shape, mesh, placements, coord=None) -> tuple[tuple, tuple]:
    """(local shape, global offset) of the shard at mesh coordinate
    ``coord`` (default: this rank's) of a tensor of global ``shape`` placed
    by ``placements``: DTensor's even split, the last shards short, in mesh
    order."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate() if coord is None else coord
    size, off = list(shape), [0] * len(shape)
    for d, p in enumerate(placements):
        if isinstance(p, Shard):
            n, c = mesh.size(d), coord[d]
            chunk = -(-size[p.dim] // n)
            start = min(chunk * c, size[p.dim])
            size[p.dim], off[p.dim] = min(chunk, size[p.dim] - start), off[p.dim] + start
    return tuple(size), tuple(off)


def distribute(tree: Any, shardings: Any):
    """``tree``'s tensors as DTensors placed by ``shardings`` (a tree of
    ``(mesh, placements)``, e.g. :func:`param_shardings`).  Every rank holds
    the whole tensor and keeps its own block, so nothing is communicated;
    a tensor without data (meta, or fake under a ``FakeTensorMode``)
    becomes an empty local block of the right shape."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import leaves_like

    out = {}
    for (name, t), (mesh, pl) in zip(flatten_with_names(tree), leaves_like(tree, shardings)):
        shape, off = local_box(t.shape, mesh, pl)
        if _holds_data(t):
            local = t[tuple(slice(o, o + n) for o, n in zip(off, shape))].contiguous()
        else:
            local = torch.empty(shape, dtype=t.dtype, device=t.device)
        out[name] = DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                                       stride=contiguous_stride(t.shape))
    return unflatten_by_name(tree, out)


def _holds_data(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake

    return not (t.is_meta or is_fake(t))


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    strides)."""
    return torch.empty(shape, device="meta").stride()


def _parts(name: str) -> list[str]:
    """A leaf name's parts; a NamedTuple field (``.opt``) without its dot."""
    return [p[1:] if p.startswith(".") else p for p in name.split("/")]


def _leaf_spec(name: str, shape, dp, mesh) -> tuple:
    parts = _parts(name)
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    rules = _param_rules(dp)
    if parent == "moe" and leaf in _MOE_EXPERT_RULES:
        spec = _MOE_EXPERT_RULES[leaf](dp)
    elif leaf == "wo_mla":
        spec = wo_mla(dp)
    elif leaf in rules:
        spec = rules[leaf]
    else:
        spec = ()  # norms, biases, scalars: replicated
    # stacked layer / period dims: leading Nones
    nd = len(shape)
    extra = nd - len(spec)
    if extra > 0:
        spec = (None,) * extra + tuple(spec)
    elif extra < 0:
        spec = tuple(spec[-nd:]) if nd else ()
    return filter_divisible(spec, shape, mesh)


# --- parallelization policy ------------------------------------------------
# "fsdp": 2-D FSDP x TP weight sharding (the default)
# "dp"  : pure data parallelism for small archs: compute weights
#         replicated, optimizer moments kept sharded (ZeRO-1), the batch
#         sharded over every mesh axis.

DP_POLICY_MAX_BYTES = 2.5e9  # replicated bf16 weights must fit comfortably


def auto_policy(params_total: int) -> str:
    return "dp" if params_total * 2 <= DP_POLICY_MAX_BYTES else "fsdp"


def _under_opt_state(name: str) -> bool:
    return any(p in ("m", "v", "residual") for p in _parts(name))


def _map_named(fn, tree):
    """A tree of ``tree``'s structure holding ``fn(name, leaf)`` at each
    leaf."""
    return unflatten_by_name(tree, {n: fn(n, leaf) for n, leaf in flatten_with_names(tree)})


def param_specs(params: Any, mesh, policy: str = "fsdp"):
    """A tree of specs for a parameter (or train-state) tree; its leaves
    are tensors or anything with ``.shape``."""
    dp = _dp(mesh)

    def leaf_spec(name, leaf):
        if policy == "dp" and not _under_opt_state(name):
            return (None,) * len(leaf.shape)  # replicated compute weights
        return _leaf_spec(name, leaf.shape, dp, mesh)

    return _map_named(leaf_spec, params)


def param_shardings(params: Any, mesh, policy: str = "fsdp"):
    """A tree of ``(mesh, placements)``, one per leaf of ``params``."""
    return shardings_of(params, param_specs(params, mesh, policy), mesh)


def shardings_of(tree: Any, specs: Any, mesh):
    """``(mesh, to_placements(spec, mesh))`` at each leaf of ``tree``, the
    spec read from ``specs`` (a tree of ``tree``'s structure)."""
    from repro_torch.tree import leaves_like

    names = [n for n, _ in flatten_with_names(tree)]
    return unflatten_by_name(tree, {n: (mesh, to_placements(s, mesh))
                                    for n, s in zip(names, leaves_like(tree, specs))})


def batch_specs(batch: Any, mesh, shard_batch: bool = True, policy: str = "fsdp"):
    """Inputs: the batch dim over the data axes (``dp`` policy: over every
    axis, where that divides), everything else replicated."""
    dp_s = _dp(mesh)
    all_axes = data_axes(mesh) + (TP,)

    def spec(_, leaf):
        nd = len(leaf.shape)
        if not shard_batch or nd == 0:
            return (None,) * nd
        tail = (None,) * (nd - 1)
        if policy == "dp" and leaf.shape[0] % axis_size(mesh, all_axes) == 0:
            return (all_axes,) + tail
        return filter_divisible((dp_s,) + tail, leaf.shape, mesh)

    return _map_named(spec, batch)


def cache_specs(cache: Any, mesh, batch_size: int, seq_len: int):
    """KV / SSM cache sharding for serving.

    batch > 1:  the batch over the data axes, the cache length over
                ``"model"`` (TP decode);
    batch == 1: (long context) the cache length over every axis
                (context-parallel decode); SSM states shard heads over
                ``"model"``.
    """
    dp = data_axes(mesh)
    dp_s = _dp(mesh)

    def spec(name, leaf):
        leaf_name = _parts(name)[-1]
        nd = len(leaf.shape)
        if leaf_name in ("k", "v", "c_kv", "k_rope"):  # (layers?, B, L, ...)
            lead = nd - (4 if leaf_name in ("k", "v") else 3)
            if batch_size == 1:
                core = (None, dp + (TP,)) if dp else (None, TP)
            else:
                core = (dp_s, TP)
            tail = nd - len(core) - lead
            out = (None,) * lead + core + (None,) * tail
        elif leaf_name == "ssm":  # (layers?, B, H, P, N)
            out = (None,) * (nd - 4) + (dp_s if batch_size > 1 else None, TP, None, None)
        elif leaf_name == "conv":  # (layers?, B, W-1, C)
            out = (None,) * (nd - 3) + (dp_s if batch_size > 1 else None, None, TP)
        elif leaf_name == "enc_out":  # (B, T, D)
            out = (dp_s if batch_size > 1 else None, None, None)
        else:
            out = (None,) * nd
        return filter_divisible(out, leaf.shape, mesh)

    return _map_named(spec, cache)
