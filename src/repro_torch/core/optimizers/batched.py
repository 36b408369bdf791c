"""Batched multi-query greedy engine (serving-shaped maximization).

``solve(spec)`` answers one selection query per call; a deployment answering
many users wants the B-query form: run B independent greedy problems — same
function family and shapes, different kernels / queries / budgets — as one
wave, so that every step sweeps all members together.

Heterogeneity is expressed with padding masks rather than shape polymorphism:

- different ground-set sizes: pad every instance's tensors to a common n and
  pass ``valid`` (B, n) — padded candidates are masked to NEG_INF and never
  selected, and ``n_evals`` counts only the live candidates, so a padded
  instance reports the same count it would sequentially;
- different budgets: pass a per-instance budget list; the engine runs to
  max(budgets) and freezes an instance once its budget is spent.

The per-instance results are bit-identical to a loop of sequential
``solve`` calls (ids, gains, ``n_evals`` and the value), the JAX package's
contract.  The engines (``greedy.py``) sweep the wave through
``backends.full_sweep_wave`` / ``partial_sweep_wave``: a family whose
backend has a wave hook sweeps every member in one kernel launch (the dense
FL sweeps, ``kernels/fl_gains.py``), the others make one launch per member,
as their sequential solves do.

The JAX package vmaps its engines over a stacked function pytree.  Here
:func:`stack_functions` stacks each tensor of the B functions once, and the
engines get member views of those stacked tensors, one function each, so
that a wave kernel reads the one resident (B, ...) tensor.  Each member's
slab starts on a 512-byte boundary, as a fresh allocation does, so that no
torch or BLAS reduction over a member's own tensors takes another path (and
order) than it takes over the sequential function's.

With ``mesh=`` the wave runs sharded over a 2-D device mesh
(``distributed.py``): the batch over ``batch_axis``, every member's
candidates over ``data_axis``, each rank holding its own slice only.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.optimizers.greedy import GreedyResult
from repro_torch.core.optimizers.spec import (
    OptimizerSpec,
    resolve_optimizer,
    wave_capable_names,
)

__all__ = ["BatchedEngine", "batched_maximize", "stack_functions"]

# elements per member slab boundary: 128 fp32 / int32 = 512 bytes, the CUDA
# caching allocator's alignment (and a multiple of the CPU allocator's 64)
_SLAB = 128

_MIXED = (
    "stack_functions: all instances must share one function family and static "
    "meta fields; got {} distinct structures"
)
_SHAPES = (
    "stack_functions: leaf shapes differ across instances — pad every "
    "kernel/feature matrix to a common ground-set size and pass a `valid` "
    "mask to BatchedEngine"
)


def _structure(obj):
    """A hashable picture of ``obj``'s tree: classes, field names and static
    values, with every tensor a placeholder (the JAX package's treedef)."""
    if isinstance(obj, torch.Tensor):
        return ("tensor",)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj),) + tuple(
            (f.name, _structure(getattr(obj, f.name))) for f in dataclasses.fields(obj)
        )
    if isinstance(obj, (tuple, list)):
        return (type(obj),) + tuple(_structure(v) for v in obj)
    try:
        hash(obj)
    except TypeError:
        return ("static", repr(obj))
    return ("static", obj)


def _stack_leaves(ts: list[torch.Tensor], device=None) -> torch.Tensor:
    """(B, ...) of equal-shape tensors, member b contiguous at b * stride,
    the stride rounded up to a whole 512-byte slab, on ``device`` (default:
    the tensors' own)."""
    t0 = ts[0]
    for t in ts[1:]:
        if t.shape != t0.shape or t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(_SHAPES)
    stride = max(_SLAB, -(-t0.numel() // _SLAB) * _SLAB)
    inner = torch.empty(t0.shape, dtype=t0.dtype, device="meta").stride()
    out = t0.new_empty((len(ts) * stride,), device=device).as_strided(
        (len(ts),) + tuple(t0.shape), (stride,) + inner
    )
    for b, t in enumerate(ts):
        out[b].copy_(t)
    return out


def _stack(objs: list):
    head = objs[0]
    if isinstance(head, torch.Tensor):
        return _stack_leaves(objs)
    if dataclasses.is_dataclass(head):
        return type(head)(**{
            f.name: _stack([getattr(o, f.name) for o in objs]) for f in dataclasses.fields(head)
        })
    if isinstance(head, (tuple, list)):
        return type(head)(_stack(list(vs)) for vs in zip(*objs))
    return head  # a static field, equal across the instances


def stack_functions(fns: Sequence):
    """Stack B same-family functions into one function of (B, ...) tensors.

    All instances must share the class, every non-tensor field (n, metric,
    use_kernel, ...) and every tensor's shape; nested sources (FeatureSource,
    DenseSource, KnnSource) and tuples are stacked field by field.  Pad
    kernels / features to a common n first and express the true sizes
    through ``valid`` masks.  :func:`member` gives instance b back as views.
    """
    fns = list(fns)
    if not fns:
        raise ValueError("stack_functions: need at least one function")
    structures = {_structure(f) for f in fns}
    if len(structures) != 1:
        raise ValueError(_MIXED.format(len(structures)))
    return _stack(fns)


def member(stacked, b: int):
    """Instance ``b`` of a :func:`stack_functions` result, every tensor a
    view of its stacked tensor (no copy)."""
    if isinstance(stacked, torch.Tensor):
        return stacked[b]
    if dataclasses.is_dataclass(stacked):
        return type(stacked)(**{
            f.name: member(getattr(stacked, f.name), b) for f in dataclasses.fields(stacked)
        })
    if isinstance(stacked, (tuple, list)):
        return type(stacked)(member(v, b) for v in stacked)
    return stacked


def _device_of(obj) -> torch.device | None:
    """The device of the first tensor in ``obj``'s tree."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    if dataclasses.is_dataclass(obj):
        children = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, (tuple, list)):
        children = list(obj)
    else:
        return None
    for c in children:
        dev = _device_of(c)
        if dev is not None:
            return dev
    return None


def wave_hook(name: str, mesh: bool = False):
    """(hook, sharded) of optimizer ``name`` for a wave, or a ``ValueError``
    naming the batched-capable set.  On a mesh an optimizer with a sharded
    engine runs it; a ``mesh_replicated`` one runs its batched hook on every
    rank (it is sequential in its data pass, so each rank computes the same
    answer)."""
    defn = resolve_optimizer(name)
    sharded = mesh and defn.sharded_run is not None
    hook = defn.sharded_run if sharded else defn.batched_run
    if hook is None or (mesh and not sharded and not defn.mesh_replicated):
        raise ValueError(
            f"optimizer {defn.name!r} does not support "
            f"{'sharded' if mesh else 'batched'} execution; "
            f"batched-capable optimizers: {wave_capable_names()}"
        )
    return hook, sharded


class BatchedEngine:
    """A reusable B-instance selection engine (the serving shape).

    Stacking B kernel / feature matrices moves O(B * n * stat) bytes, so the
    engine does it once, at construction, and then answers many selection
    calls against the resident batch (:meth:`run`).  It keeps the stacked
    copy only, so the caller may drop the functions it was built from.

    With ``mesh=`` (a mesh from ``distributed.make_mesh``; every rank builds
    the engine with the same functions) each rank keeps its slice of the
    batch instead (``distributed.ShardedWave``): the batch over
    ``batch_axis``, the candidates over ``data_axis``; B and n must each be
    a multiple of that axis's size.  The functions stay referenced there,
    for an optimizer that runs replicated on a mesh.
    """

    def __init__(
        self,
        fns: Sequence,
        valid=None,
        mesh=None,
        batch_axis: str = "batch",
        data_axis: str = "data",
    ):
        fns = list(fns)
        if not fns:
            raise ValueError("BatchedEngine: need at least one instance")
        self.batch_size = len(fns)
        self.n = fns[0].n
        self.mesh = mesh
        self._fns = None
        if mesh is None:
            self._stack(fns)
        else:
            from repro_torch.core.optimizers.distributed import ShardedWave

            self._fns, self._members = fns, None
            self.wave = ShardedWave(fns, mesh, valid=valid, batch_axes=(batch_axis,),
                                    col_axes=(data_axis,))
        self.device = _device_of(fns[0]) or torch.device("cpu")
        if valid is None:
            self.valid = torch.ones((self.batch_size, self.n), dtype=torch.bool, device=self.device)
        else:
            self.valid = torch.as_tensor(valid).to(device=self.device, dtype=torch.bool)
        if tuple(self.valid.shape) != (self.batch_size, self.n):
            raise ValueError(
                f"valid mask must be ({self.batch_size}, {self.n}), "
                f"got {tuple(self.valid.shape)}"
            )

    def _stack(self, fns) -> None:
        self.stacked = stack_functions(fns)
        self._members = [member(self.stacked, b) for b in range(self.batch_size)]

    @property
    def members(self) -> list:
        """The member views of the stacked functions; stacked lazily on a
        mesh, where only a replicated optimizer needs them."""
        if self._members is None:
            self._stack(self._fns)
        return self._members

    def run(
        self,
        budget: int | Sequence[int],
        optimizer: OptimizerSpec | str = "NaiveGreedy",
        *,
        stop_if_zero: bool = True,
        stop_if_negative: bool = True,
        max_budget: int | None = None,
    ) -> list[GreedyResult]:
        """Solve the resident batch through the optimizer registry.

        The optimizer (an :class:`OptimizerSpec`, or a name built into one)
        carries its validated hyperparameters, and the registry supplies the
        batched hook (the sharded one on a mesh); an optimizer without one
        is rejected here with the batched-capable set named.  ``max_budget``
        optionally raises the loop bound above max(budgets).  The results
        lie on the host: one transfer for the whole wave (on a mesh, every
        rank gets the whole batch's).
        """
        opt = optimizer if isinstance(optimizer, OptimizerSpec) else OptimizerSpec(optimizer)
        hook, sharded = wave_hook(opt.name, self.mesh is not None)
        B = self.batch_size
        budgets = (
            [int(budget)] * B
            if isinstance(budget, (int, np.integer))
            else [int(b) for b in budget]
        )
        if len(budgets) != B:
            raise ValueError(f"budget list has {len(budgets)} entries for {B} instances")
        max_budget = max(budgets) if max_budget is None else int(max_budget)
        if max_budget < max(budgets):
            raise ValueError(
                f"max_budget {max_budget} < largest per-instance budget {max(budgets)}"
            )
        if sharded:
            res = hook(self.wave, max_budget, budgets, stop_if_zero, stop_if_negative,
                       **opt.params)
        else:
            b_arr = torch.tensor(budgets, dtype=torch.int32, device=self.device)
            res = hook(
                self.members, max_budget, b_arr, self.valid, stop_if_zero,
                stop_if_negative, **opt.params,
            )
        # the hook reports each member's value as its sequential solve does
        values = res.value.to(torch.float32)
        # one transfer for the whole wave, then host-side slicing
        packed = torch.cat([
            res.order.reshape(-1),
            res.gains.reshape(-1).view(torch.int32),
            res.n_evals.to(torch.int32),
            values.view(torch.int32),
        ]).cpu()
        cut = B * max_budget
        order = packed[:cut].reshape(B, max_budget)
        gains = packed[cut : 2 * cut].view(torch.float32).reshape(B, max_budget)
        evals = packed[2 * cut : 2 * cut + B]
        vals = packed[2 * cut + B :].view(torch.float32)
        return [
            GreedyResult(order=order[b, :bud], gains=gains[b, :bud], n_evals=evals[b],
                         value=vals[b])
            for b, bud in enumerate(budgets)
        ]

    def maximize(
        self,
        budget: int | Sequence[int],
        optimizer: str = "NaiveGreedy",
        return_result: bool = False,
        max_budget: int | None = None,
        **kwargs,
    ) -> list:
        """Deprecated: delegate to :meth:`run` with an :class:`OptimizerSpec`
        built from ``optimizer`` + kwargs (unknown options raise)."""
        from repro_torch.core.optimizers.api import _warn_shim

        _warn_shim(
            "BatchedEngine.maximize()",
            "BatchedEngine.run(budgets, OptimizerSpec(...))",
        )
        opt, stop_zero, stop_neg = _legacy_optimizer_spec(optimizer, kwargs)
        results = self.run(
            budget, opt, stop_if_zero=stop_zero, stop_if_negative=stop_neg,
            max_budget=max_budget,
        )
        return results if return_result else [r.as_list() for r in results]


def _legacy_optimizer_spec(optimizer: str, kwargs: dict):
    """Split legacy ``**kwargs`` into (OptimizerSpec, stop_zero, stop_neg).

    Stop rules keep their old engine-level ``True`` defaults (family
    defaults are a spec-layer concern); everything else is validated as
    optimizer hyperparameters, so a misspelled flag raises."""
    kwargs = dict(kwargs)
    stop_zero = bool(kwargs.pop("stopIfZeroGain", True))
    stop_neg = bool(kwargs.pop("stopIfNegativeGain", True))
    return OptimizerSpec(optimizer, **kwargs), stop_zero, stop_neg


def batched_maximize(
    fns: Sequence,
    budget: int | Sequence[int],
    optimizer: str = "NaiveGreedy",
    valid=None,
    return_result: bool = False,
    mesh=None,
    batch_axis: str = "batch",
    data_axis: str = "data",
    **kwargs,
) -> list:
    """Deprecated one-shot wrapper: solve B selection problems in one wave.
    Use ``solve([SelectionSpec(...), ...], mode="batched")``; for a padded
    batch with a ``valid`` mask, build a :class:`BatchedEngine` and call
    :meth:`BatchedEngine.run`.

    ``budget`` is a shared int or one per instance; ``valid`` an optional
    (B, n) bool mask (False marks padded candidates); ``return_result`` True
    gives per-instance :class:`GreedyResult` objects, False submodlib-style
    [(index, gain), ...] lists; kwargs are stopIfZeroGain /
    stopIfNegativeGain and the optimizer's hyperparameters.
    """
    from repro_torch.core.optimizers.api import _warn_shim

    _warn_shim("batched_maximize()", 'solve([SelectionSpec(...), ...], mode="batched")')
    fns = list(fns)
    if not fns:
        return []
    opt, stop_zero, stop_neg = _legacy_optimizer_spec(optimizer, kwargs)
    engine = BatchedEngine(fns, valid=valid, mesh=mesh, batch_axis=batch_axis, data_axis=data_axis)
    results = engine.run(budget, opt, stop_if_zero=stop_zero, stop_if_negative=stop_neg)
    return results if return_result else [r.as_list() for r in results]
