"""Activation-sharding hints (the JAX package's
``distributed/act_sharding.py``).

Model code calls ``constrain(x, roles)`` at layer boundaries.  Inside an
:func:`activation_sharding` context (set by ``launch/dryrun.py`` and by
sharded training), a ``DTensor`` activation is redistributed to the
placements its roles name; a plain tensor, or any tensor outside a
context, passes through unchanged (``with_sharding_constraint``'s
counterpart).

Roles: ``"dp"`` -> the data axes (``"pod"``, ``"data"``), ``"tp"`` ->
``"model"``, ``None`` -> replicated.

A product over activations split over two mesh axes (the batch over the
data axes, heads, groups or experts over the model axis) runs on each
rank's local blocks (:func:`local_blocks`), and a view that would fold a
split dim behind another gathers it first (:func:`mergeable`,
:func:`whole_tokens`): DTensor never folds a split dim that is not its
group's first, which torch 2.11's refuses to do.  The layout so does not
depend on the installed torch.

Inside an enabled context a plain tensor that meets a DTensor (positions,
RoPE tables, masks) is taken as replicated on the DTensor's mesh
(``implicit_replication``).
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from repro_torch.distributed.sharding import TP, axis_size, data_axes, to_placements

_CTX: dict | None = None


@contextlib.contextmanager
def activation_sharding(mesh, enable: bool = True, policy: str = "fsdp"):
    """The role table for ``mesh`` under ``policy``, the JAX package's:
    ``"tp"`` names the model axis under every policy but ``dp``, which
    puts every axis on the batch and turns the TP roles off."""
    from torch.distributed.tensor.experimental import implicit_replication

    global _CTX
    prev = _CTX
    dp = data_axes(mesh)
    all_axes = dp + (TP,)
    tp = TP if policy != "dp" else None
    _CTX = (
        {
            # pure-DP policy: the batch carries every axis; no TP roles
            "dp": all_axes if policy == "dp" else (dp if len(dp) > 1 else (dp[0] if dp else None)),
            "tp": tp,
            "dptp": all_axes,
            "mesh": mesh,
        }
        if enable
        else None
    )
    try:
        with implicit_replication() if enable else contextlib.nullcontext():
            yield
    finally:
        _CTX = prev


def tp_size() -> int:
    """The model axis' size in the active context (1 outside one, or when
    the ``dp`` policy turned the TP roles off)."""
    return 1 if _CTX is None else axis_size(_CTX["mesh"], _CTX["tp"])


def splits_activations() -> bool:
    """Whether the active context splits activations over the model axis
    (the ``"tp"`` role is on): False outside one and under ``dp``."""
    return _CTX is not None and _CTX["tp"] is not None


def _spec(roles: Sequence[str | None], shape, entries: dict | None = None) -> tuple:
    """The spec entry of each role in the active context; an axis that does
    not divide its dim is dropped.  With ``entries``, a role takes the entry
    held there, and the first dim to carry it sets it."""
    mesh, spec = _CTX["mesh"], []
    for r, dim in zip(roles, shape):
        if entries is not None and r in entries:
            spec.append(entries[r])
            continue
        entry = _CTX.get(r) if r else None
        if entry is not None and dim % axis_size(mesh, entry):
            entry = None
        if entries is not None and r:
            entries[r] = entry
        spec.append(entry)
    return tuple(spec)


def constrain(x: torch.Tensor, roles: Sequence[str | None]) -> torch.Tensor:
    """roles: one entry per dim of ``x``, each ``"dp"``, ``"tp"`` or None.
    An axis that does not divide its dim is dropped (the parameters' rule)."""
    from torch.distributed.tensor import DTensor

    if _CTX is None or not isinstance(x, DTensor):
        return x
    mesh = _CTX["mesh"]
    return dense(x.redistribute(mesh, to_placements(_spec(roles, x.shape), mesh)))


def local_blocks(fn, in_roles: Sequence, out_roles: Sequence):
    """``fn`` run on each rank's local blocks, through torch's ``local_map``
    with placements named by roles: the returned function places each
    tensor argument by its roles (``in_roles``, one per argument, as
    :func:`constrain` takes them; a plain tensor with roles is taken as
    replicated first, None passes the argument as it is), calls ``fn`` on
    the local tensors and wraps its result, a tensor or a tuple of them, in
    the placements ``out_roles`` names (one roles tuple, or a tuple of
    them) with roles the arguments carry.  A role takes the axes that the
    first argument dim carrying it got, so a role that an argument's dim
    did not divide is off for every tensor of the call.

    ``fn``'s work must be independent across every split dim: no region
    holds a collective, and no view inside it meets a DTensor, so DTensor
    never folds a split dim there (torch 2.11's refuses to fold one that is
    not its group's first).  The gradient comes back through the same
    placements; an argument replicated over a mesh dim that an output is
    split over gets its gradient as a partial sum there
    (``in_grad_placements``).  Outside a context, or without a DTensor
    argument, ``fn`` is called directly."""

    def run(*args):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        if _CTX is None or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        mesh, entries = _CTX["mesh"], {}
        places = [None if r is None or a is None else
                  to_placements(_spec(r, a.shape, entries), mesh)
                  for r, a in zip(in_roles, args)]
        several = isinstance(out_roles[0], (tuple, list))
        outs = [to_placements(_spec(r, (0,) * len(r), entries), mesh)
                for r in (out_roles if several else (out_roles,))]
        split = {m for pl in outs for m, p in enumerate(pl) if isinstance(p, Shard)}
        grads = [None if pl is None else
                 tuple(Partial() if m in split and isinstance(p, Replicate) else p
                       for m, p in enumerate(pl))
                 for pl in places]
        args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
                if pl is not None and not isinstance(a, DTensor) else a
                for a, pl in zip(args, places)]
        # one output's placements go as a list: a tuple names one per output
        return local_map(fn, out_placements=tuple(outs) if several else list(outs[0]),
                         in_placements=tuple(places), in_grad_placements=tuple(grads),
                         device_mesh=mesh, redistribute_inputs=True)(*args)

    return run


def mergeable(x: torch.Tensor, first: int, last: int) -> torch.Tensor:
    """``x`` ready for its dims ``first`` .. ``last`` to be folded into one
    (a view or a product over them): a DTensor split over one of them
    after the first is all-gathered over it, as DTensor cannot fold a split
    dim that is not its group's first (torch 2.11 refuses; a later torch
    makes a strided shard that a product then gathers).  Its gradient comes
    back in ``x``'s placements.  A plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    inner = [isinstance(p, Shard) and first % x.ndim < p.dim <= last % x.ndim
             for p in x.placements]
    return x.redistribute(x.device_mesh, [Replicate() if i else p
                                          for i, p in zip(inner, x.placements)])


def whole_tokens(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, ..., D) ready for a product over its last dim, which folds
    every dim before it into one (:func:`mergeable`): a split over a dim
    other than the batch and the last (the residual's sequence under
    Megatron-SP) is all-gathered, as Megatron-SP gathers before a
    column-parallel product.  A plain tensor as it is."""
    return mergeable(x, 0, -2)


def pin(x: torch.Tensor) -> torch.Tensor:
    """A DTensor passed through a redistribution to its own placements:
    nothing moves forward, and its gradient comes back in these placements,
    resharded here from however backward left it (a view's inverse then
    applies).  A plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.redistribute(x.device_mesh, x.placements) if isinstance(x, DTensor) else x


def _order(shape, stride) -> list[int]:
    """The dims of more than one element, outermost in memory first."""
    return sorted((i for i, n in enumerate(shape) if n > 1), key=lambda i: -stride[i])


def _agree(x) -> bool:
    local = x.to_local()
    return _order(x.shape, x.stride()) == _order(local.shape, local.stride())


class _Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x if _agree(x) else x.contiguous()

    @staticmethod
    def backward(ctx, g):
        return g if _agree(g) else g.contiguous()


def dense(x: torch.Tensor) -> torch.Tensor:
    """A DTensor whose global strides describe its local block, forward and
    backward.  A redistribution or a pointwise op can leave a contiguous
    local block under the global strides of a permuted layout; a later view
    (inside einsum) is then legal globally and fails locally.  Where the two
    layouts disagree the tensor (or its gradient) is made contiguous; where
    they agree, and for a plain tensor, nothing changes."""
    from torch.distributed.tensor import DTensor

    return _Dense.apply(x) if isinstance(x, DTensor) else x
