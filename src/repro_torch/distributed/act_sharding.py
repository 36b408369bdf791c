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


def folds_split_dims(mesh) -> bool:
    """Whether this torch's DTensor folds a dim split over the model axis
    into the dim before it (the view a product makes of (B, L, D) or an
    einsum of its batch dims): torch 2.13 does, with a strided shard;
    torch 2.11 refuses.  Probed on a meta DTensor; True where nothing can
    be split over the model axis (it holds one rank, or ``mesh`` only names
    axes and sizes, as a test's stand-in does)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if (not isinstance(mesh, DeviceMesh) or TP not in mesh.mesh_dim_names
            or axis_size(mesh, TP) < 2):
        return True
    model = mesh.mesh_dim_names.index(TP)
    placements = [Shard(1) if d == model else Replicate() for d in range(mesh.ndim)]
    n = mesh.size(model)
    x = DTensor.from_local(torch.empty(2, 1, 1, device="meta"), mesh, placements,
                           run_check=False, shape=(2, n, 1), stride=(n, 1, 1))
    try:
        x.view(2 * n, 1)
    except RuntimeError:
        return False
    return True


@contextlib.contextmanager
def activation_sharding(mesh, enable: bool = True, policy: str = "fsdp"):
    """The role table for ``mesh`` under ``policy``.  Where this torch's
    DTensor cannot fold a split dim (:func:`folds_split_dims`), no
    activation is split over the model axis: the ``"tp"`` role is off, as
    under ``dp``, while the parameters keep their ``fsdp`` placements and
    :func:`tp_size` still gives the model axis' size, so the function
    computed (the MoE group count) does not depend on the installed torch."""
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
            "tp": tp if tp and folds_split_dims(mesh) else None,
            "dptp": all_axes,
            "mesh": mesh,
            "tp_axis": tp,  # what tp_size() reads, whether or not "tp" splits
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
    return 1 if _CTX is None else axis_size(_CTX["mesh"], _CTX["tp_axis"])


def splits_activations() -> bool:
    """Whether the active context splits activations over the model axis
    (the ``"tp"`` role is on): False outside one, under ``dp``, and where
    :func:`folds_split_dims` fails."""
    return _CTX is not None and _CTX["tp"] is not None


def constrain(x: torch.Tensor, roles: Sequence[str | None]) -> torch.Tensor:
    """roles: one entry per dim of ``x``, each ``"dp"``, ``"tp"`` or None.
    An axis that does not divide its dim is dropped (the parameters' rule)."""
    from torch.distributed.tensor import DTensor

    if _CTX is None or not isinstance(x, DTensor):
        return x
    mesh = _CTX["mesh"]
    spec = []
    for r, dim in zip(roles, x.shape):
        entry = _CTX.get(r) if r else None
        if entry is not None and dim % axis_size(mesh, entry):
            entry = None
        spec.append(entry)
    return dense(x.redistribute(mesh, to_placements(tuple(spec), mesh)))


def whole_tokens(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, ..., D) ready for a product over its last dim, which folds
    every dim before it into one: a DTensor split over a dim other than the
    batch and the last (the residual's sequence under Megatron-SP) is
    all-gathered over it, as Megatron-SP gathers before a column-parallel
    product (torch 2.11's DTensor cannot fold a split dim that is not its
    group's first).  Its gradient comes back in ``x``'s placements (as for
    :func:`pin`).  A plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    inner = [isinstance(p, Shard) and 0 < p.dim < x.ndim - 1 for p in x.placements]
    return x.redistribute(x.device_mesh, [Replicate() if i else p
                                          for i, p in zip(inner, x.placements)])


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
