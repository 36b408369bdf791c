"""Typed selection specs and the ``solve()`` front door.

- :class:`OptimizerSpec` — an optimizer name plus validated, defaulted
  hyperparameters, backed by the :func:`register_optimizer` registry.
  Unknown names raise ``ValueError`` naming the registered set; unknown or
  ill-typed hyperparameters raise ``TypeError`` naming the valid set — at
  construction, before anything runs.
- :class:`SelectionSpec` — function + budget + optimizer spec + stop rules +
  backend choice.  Stop-rule defaults resolve against the per-family table
  (:func:`register_family_defaults`) in exactly one place.
- :func:`solve` — the front door: ``solve(spec)`` or ``solve([s1, s2])``.

Ported so far: the sequential and batched modes, NaiveGreedy and
LazyGreedy.  The sharded, served and async modes, ``deadline_s`` /
``retry`` and the other optimizers are still to be ported (ROADMAP queue
1, items 9-11).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

from repro_torch.core.functions.base import SetFunction
from repro_torch.core.optimizers.greedy import (
    GreedyResult,
    _lazy_bucketed_impl,
    _naive_impl,
    lazy_greedy,
    naive_greedy,
)

__all__ = [
    "OptimizerSpec",
    "SelectionSpec",
    "solve",
    "register_optimizer",
    "register_family_defaults",
    "optimizer_names",
    "resolve_optimizer",
    "family_defaults",
    "wave_capable_names",
]


# ---------------------------------------------------------------------------
# Hyperparameter validation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Param:
    """One optimizer hyperparameter: its default and a coercing validator.

    ``convert`` receives the user value and returns the normalized form, or
    raises ``TypeError`` / ``ValueError`` with an actionable message.
    """

    default: object
    convert: Callable[[object], object]
    doc: str = ""


def _int_min(lo: int) -> Callable:
    def convert(v):
        i = int(v)
        if i < lo:
            raise ValueError(f"must be an int >= {lo}, got {v!r}")
        return i

    return convert


# ---------------------------------------------------------------------------
# Optimizer registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OptimizerDef:
    """A registered optimizer: hyperparameter schema + execution hooks.

    ``run(fn, budget, stop_zero, stop_neg, **params) -> GreedyResult``
    answers one sequential query.  ``batched_run(fns, max_budget, budgets,
    valid, stop_zero, stop_neg, **params)`` runs a wave for
    :class:`~repro_torch.core.optimizers.batched.BatchedEngine` (``fns`` the
    engine's member views, ``budgets`` (B,) and ``valid`` (B, n) tensors)
    and returns a (B, ...) result.  ``sharded_run`` and ``mesh_replicated``
    are the JAX package's mesh hooks, kept in the registry for the sharded
    engine (ROADMAP queue 1, item 11); nothing in the port calls them yet.
    ``None`` means the optimizer cannot ride that route: it is rejected
    before anything runs.
    """

    name: str
    params: Mapping[str, Param]
    run: Callable
    batched_run: Optional[Callable] = None
    sharded_run: Optional[Callable] = None
    mesh_replicated: bool = False

    @property
    def batched_capable(self) -> bool:
        # The JAX package also asks for a sharded hook (or mesh_replicated),
        # since every wave may land on a mesh there.  The port has no sharded
        # engine until ROADMAP item 11, so a batched hook is enough here.
        return self.batched_run is not None


_OPTIMIZERS: dict[str, OptimizerDef] = {}


def register_optimizer(
    name: str,
    run: Callable,
    *,
    params: Mapping[str, Param] | None = None,
    batched_run: Callable | None = None,
    sharded_run: Callable | None = None,
    mesh_replicated: bool = False,
) -> OptimizerDef:
    """Register (or replace) an optimizer under ``name``.

    ``params`` maps hyperparameter names to :class:`Param` (default +
    validator); :class:`OptimizerSpec` construction validates against it, so
    a misspelled option fails with a ``TypeError`` naming the valid set.
    ``batched_run`` / ``sharded_run`` / ``mesh_replicated`` are the wave
    hooks of :class:`OptimizerDef`.
    """
    defn = OptimizerDef(
        name=name,
        params=dict(params or {}),
        run=run,
        batched_run=batched_run,
        sharded_run=sharded_run,
        mesh_replicated=mesh_replicated,
    )
    _OPTIMIZERS[name] = defn
    return defn


def optimizer_names() -> list[str]:
    """The registered optimizer names, sorted."""
    return sorted(_OPTIMIZERS)


def resolve_optimizer(name: str) -> OptimizerDef:
    """The :class:`OptimizerDef` registered under ``name``, or a
    ``ValueError`` naming the registered set."""
    defn = _OPTIMIZERS.get(name)
    if defn is None:
        raise ValueError(
            f"unknown optimizer {name!r}; choose from {optimizer_names()} "
            "(register new ones via repro_torch.core.register_optimizer)"
        )
    return defn


def wave_capable_names() -> list[str]:
    """The optimizers a wave route (batched) accepts: the single source for
    every 'batched-capable optimizers: [...]' rejection."""
    return [n for n in optimizer_names() if _OPTIMIZERS[n].batched_capable]


# ---------------------------------------------------------------------------
# OptimizerSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, init=False)
class OptimizerSpec:
    """A validated (optimizer name, hyperparameters) pair.

        OptimizerSpec("LazyGreedy", screen_k=16)

    Unspecified hyperparameters are filled with their registered defaults at
    construction, so ``spec.params`` is always the complete resolved set.
    Instances are hashable.
    """

    name: str
    _params: tuple  # sorted ((name, value), ...), fully defaulted

    def __init__(self, name: str, **params):
        if isinstance(name, OptimizerSpec):  # idempotent copy-construction
            if params:
                raise TypeError(
                    "cannot pass hyperparameters alongside an existing "
                    "OptimizerSpec; build a new one instead"
                )
            object.__setattr__(self, "name", name.name)
            object.__setattr__(self, "_params", name._params)
            return
        defn = resolve_optimizer(name)
        unknown = set(params) - set(defn.params)
        if unknown:
            raise TypeError(
                f"{defn.name} got unknown option(s) {sorted(unknown)}; "
                f"valid options: {sorted(defn.params)}"
            )
        resolved = {}
        for pname, p in defn.params.items():
            value = params.get(pname, p.default)
            try:
                resolved[pname] = p.convert(value)
            except (TypeError, ValueError) as e:
                raise TypeError(
                    f"invalid value for {defn.name} option {pname!r}: {e}"
                ) from None
        object.__setattr__(self, "name", defn.name)
        object.__setattr__(self, "_params", tuple(sorted(resolved.items())))

    @property
    def params(self) -> dict:
        """The fully-resolved hyperparameters as a plain dict."""
        return dict(self._params)

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v!r}" for k, v in self._params)
        return f"OptimizerSpec({self.name!r}{', ' if args else ''}{args})"


# ---------------------------------------------------------------------------
# Per-family stop-rule defaults (the one resolution point)
# ---------------------------------------------------------------------------

_LIBRARY_STOP_DEFAULTS = {"stopIfZeroGain": True, "stopIfNegativeGain": True}

# class -> partial overrides of the library defaults; resolved along the MRO
# (most-derived class wins)
_FAMILY_DEFAULTS: dict[type, dict[str, bool]] = {}


def register_family_defaults(cls: type, **defaults: bool) -> None:
    """Override stop-rule defaults for a function family (and subclasses).

    Accepted keys: ``stopIfZeroGain`` / ``stopIfNegativeGain``.  Consumed by
    :class:`SelectionSpec` when the caller leaves a stop rule unset.
    """
    unknown = set(defaults) - set(_LIBRARY_STOP_DEFAULTS)
    if unknown:
        raise TypeError(
            f"unknown stop-rule default(s) {sorted(unknown)}; "
            f"valid: {sorted(_LIBRARY_STOP_DEFAULTS)}"
        )
    _FAMILY_DEFAULTS.setdefault(cls, {}).update(
        {k: bool(v) for k, v in defaults.items()}
    )


def family_defaults(cls: type) -> dict[str, bool]:
    """The resolved stop-rule defaults for ``cls`` (library defaults merged
    with registered per-family overrides, most-derived class winning)."""
    out = dict(_LIBRARY_STOP_DEFAULTS)
    for klass in reversed(cls.__mro__):
        out.update(_FAMILY_DEFAULTS.get(klass, {}))
    return out


# ---------------------------------------------------------------------------
# SelectionSpec
# ---------------------------------------------------------------------------

# SelectionSpec options of the JAX package that wait for the serving slice
_NOT_PORTED = {"deadline_s", "retry"}


@dataclasses.dataclass(frozen=True, init=False, eq=False)
class SelectionSpec:
    """One selection request: select ``budget`` items under ``fn``.

        SelectionSpec(fn, budget=8, optimizer="LazyGreedy", screen_k=16)

    Validation happens here, at construction: unknown optimizers, unknown
    or ill-typed hyperparameters, non-function ``fn`` objects, and backend
    overrides the family cannot honor all raise before anything runs.  Stop
    rules left as ``None`` resolve against the per-family default table.

    ``use_kernel`` is the backend choice: ``None`` leaves the function as
    built; ``True`` / ``False`` rebuilds it with the CUDA kernel sweep
    forced on / off at solve time (only for families exposing the flag).
    """

    fn: object
    budget: int
    optimizer: OptimizerSpec
    stop_if_zero: bool
    stop_if_negative: bool
    use_kernel: Optional[bool]

    def __init__(
        self,
        fn,
        budget: int,
        optimizer: str | OptimizerSpec = "NaiveGreedy",
        *,
        stopIfZeroGain: bool | None = None,
        stopIfNegativeGain: bool | None = None,
        use_kernel: bool | None = None,
        **optimizer_params,
    ):
        if not isinstance(fn, SetFunction):
            raise TypeError(
                "SelectionSpec needs a SetFunction instance (e.g. "
                "FacilityLocation.from_kernel(...)); got "
                f"{type(fn).__name__!r}"
            )
        waiting = _NOT_PORTED & set(optimizer_params)
        if waiting:
            raise TypeError(
                f"{sorted(waiting)} are not ported to repro_torch yet; they "
                "come with the serving slice (ROADMAP queue 1, item 10)"
            )
        if isinstance(optimizer, OptimizerSpec):
            if optimizer_params:
                raise TypeError(
                    "cannot pass optimizer hyperparameters "
                    f"{sorted(optimizer_params)} alongside an OptimizerSpec; "
                    "set them on the OptimizerSpec itself"
                )
            opt = optimizer
        else:
            defn = resolve_optimizer(optimizer)
            unknown = set(optimizer_params) - set(defn.params)
            if unknown:
                valid = sorted(defn.params) + [
                    "stopIfZeroGain",
                    "stopIfNegativeGain",
                    "use_kernel",
                ]
                raise TypeError(
                    f"{defn.name} got unknown option(s) {sorted(unknown)}; "
                    f"valid options: {valid}"
                )
            opt = OptimizerSpec(optimizer, **optimizer_params)
        budget = int(budget)
        if budget < 1:
            raise ValueError(f"budget must be a positive int, got {budget}")
        if use_kernel is not None:
            names = {f.name for f in dataclasses.fields(fn)}
            if "use_kernel" not in names:
                raise TypeError(
                    f"{type(fn).__name__} has no use_kernel backend flag; "
                    "leave use_kernel=None for this family"
                )
            use_kernel = bool(use_kernel)
        defaults = family_defaults(type(fn))
        stop_zero = (
            defaults["stopIfZeroGain"] if stopIfZeroGain is None else bool(stopIfZeroGain)
        )
        stop_neg = (
            defaults["stopIfNegativeGain"]
            if stopIfNegativeGain is None
            else bool(stopIfNegativeGain)
        )
        object.__setattr__(self, "fn", fn)
        object.__setattr__(self, "budget", budget)
        object.__setattr__(self, "optimizer", opt)
        object.__setattr__(self, "stop_if_zero", stop_zero)
        object.__setattr__(self, "stop_if_negative", stop_neg)
        object.__setattr__(self, "use_kernel", use_kernel)
        self.resolved_fn()  # a backend the family cannot honor raises here

    def resolved_fn(self):
        """The function with the spec's backend choice applied (identity when
        ``use_kernel`` is None or already matches)."""
        if self.use_kernel is None or self.use_kernel == self.fn.use_kernel:
            return self.fn
        return dataclasses.replace(self.fn, use_kernel=self.use_kernel)

    def __repr__(self) -> str:
        return (
            f"SelectionSpec({type(self.fn).__name__}(n={self.fn.n}), "
            f"budget={self.budget}, optimizer={self.optimizer!r}, "
            f"stopIfZeroGain={self.stop_if_zero}, "
            f"stopIfNegativeGain={self.stop_if_negative}, "
            f"use_kernel={self.use_kernel})"
        )


# ---------------------------------------------------------------------------
# solve(): the one front door
# ---------------------------------------------------------------------------

_MODES = ("sequential", "batched", "sharded", "served", "async")
# execution routes of the JAX package that are still to be ported
_WAITING_MODES = {
    "sharded": "the sharded engine over a 2-D mesh=, ROADMAP queue 1, item 11",
    "served": "the serving slice, ROADMAP queue 1, item 10",
    "async": "the serving slice, ROADMAP queue 1, item 10",
}


def solve(
    spec: SelectionSpec | Sequence[SelectionSpec],
    *,
    mode: str | None = None,
    mesh=None,
    batch_axis: str = "batch",
    data_axis: str = "data",
    server=None,
):
    """Solve one spec, or a batch of specs, through one execution route.

    ``spec`` is a :class:`SelectionSpec` (returns one :class:`GreedyResult`)
    or a sequence of them (returns a list in the same order).  ``mode`` is
    ``"sequential"`` (the default for one spec; a Python loop for several)
    or ``"batched"`` (the default for several: one wave through
    :class:`~repro_torch.core.optimizers.batched.BatchedEngine`; the specs
    must share the optimizer spec and stop rules, and their functions one
    family and shape).  A batched result lies on the host, moved there in
    one transfer for the wave.

    The JAX package's ``"sharded"`` route (also chosen by passing ``mesh=``),
    ``"served"`` and ``"async"`` routes and its ``server=`` raise
    ``ValueError`` naming the ROADMAP item that brings them; every route
    returns results bit-identical to the sequential one by contract.
    """
    single = isinstance(spec, SelectionSpec)
    specs = [spec] if single else list(spec)
    for i, s in enumerate(specs):
        if not isinstance(s, SelectionSpec):
            raise TypeError(
                f"solve() takes SelectionSpec objects; item {i} is "
                f"{type(s).__name__!r}"
            )
    if mode is None:
        mode = "sequential" if single and mesh is None else "batched"
    if mode == "batched" and mesh is not None:
        mode = "sharded"
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {list(_MODES)}")
    if not specs:
        return []
    if mode in _WAITING_MODES:
        raise ValueError(
            f"mode={mode!r} is not ported to repro_torch yet "
            f"({_WAITING_MODES[mode]}); use mode='sequential' or 'batched'"
        )
    if server is not None:
        raise ValueError(
            "server= serves the 'served' and 'async' routes, which are not "
            f"ported to repro_torch yet ({_WAITING_MODES['served']})"
        )
    if mode == "sequential":
        results = [_run_sequential(s) for s in specs]
    else:
        results = _run_batched(specs)
    return results[0] if single else results


def _run_sequential(spec: SelectionSpec) -> GreedyResult:
    defn = resolve_optimizer(spec.optimizer.name)
    return defn.run(
        spec.resolved_fn(),
        spec.budget,
        spec.stop_if_zero,
        spec.stop_if_negative,
        **spec.optimizer.params,
    )


def _check_uniform(specs: Sequence[SelectionSpec], what: str) -> None:
    head = specs[0]
    for s in specs[1:]:
        if (
            s.optimizer != head.optimizer
            or s.stop_if_zero != head.stop_if_zero
            or s.stop_if_negative != head.stop_if_negative
        ):
            raise ValueError(
                f"mode={what!r} runs one wave, so every spec must share the "
                "optimizer spec and stop rules; mixed workloads belong in "
                'mode="served" (the coalescer groups them into waves)'
            )


def _run_batched(specs) -> list[GreedyResult]:
    from repro_torch.core.optimizers.batched import BatchedEngine, batched_hook

    _check_uniform(specs, "batched")
    head = specs[0]
    batched_hook(head.optimizer.name)  # an optimizer without one raises before stacking
    engine = BatchedEngine([s.resolved_fn() for s in specs])
    return engine.run(
        [s.budget for s in specs],
        head.optimizer,
        stop_if_zero=head.stop_if_zero,
        stop_if_negative=head.stop_if_negative,
    )


# ---------------------------------------------------------------------------
# Built-in optimizer registrations
# ---------------------------------------------------------------------------

def _naive_run(fn, budget, stop_zero, stop_neg):
    return naive_greedy(fn, budget, stop_zero, stop_neg)


def _naive_batched(fns, max_budget, budgets, valid, stop_zero, stop_neg):
    return _naive_impl(fns, max_budget, stop_zero, stop_neg, budgets=budgets, valid=valid)


def _lazy_run(fn, budget, stop_zero, stop_neg, *, screen_k):
    return lazy_greedy(fn, budget, screen_k, stop_zero, stop_neg)


def _lazy_batched(fns, max_budget, budgets, valid, stop_zero, stop_neg, *, screen_k):
    return _lazy_bucketed_impl(fns, max_budget, budgets, valid, screen_k, stop_zero, stop_neg)


register_optimizer("NaiveGreedy", _naive_run, batched_run=_naive_batched)
register_optimizer(
    "LazyGreedy",
    _lazy_run,
    params={"screen_k": Param(8, _int_min(1), "lazy screen width (doubling levels)")},
    batched_run=_lazy_batched,
)
