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

Ported so far: sequential mode, NaiveGreedy and LazyGreedy.  The batched,
sharded, served and async modes, ``deadline_s`` / ``retry`` and the other
optimizers are still to be ported (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

from repro_torch.core.functions.base import SetFunction
from repro_torch.core.optimizers.greedy import GreedyResult, lazy_greedy, naive_greedy

__all__ = [
    "OptimizerSpec",
    "SelectionSpec",
    "solve",
    "register_optimizer",
    "register_family_defaults",
    "optimizer_names",
    "resolve_optimizer",
    "family_defaults",
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
    """A registered optimizer: hyperparameter schema + its sequential run
    hook ``run(fn, budget, stop_zero, stop_neg, **params) -> GreedyResult``."""

    name: str
    params: Mapping[str, Param]
    run: Callable


_OPTIMIZERS: dict[str, OptimizerDef] = {}


def register_optimizer(
    name: str, run: Callable, *, params: Mapping[str, Param] | None = None
) -> OptimizerDef:
    """Register (or replace) an optimizer under ``name``.

    ``params`` maps hyperparameter names to :class:`Param` (default +
    validator); :class:`OptimizerSpec` construction validates against it, so
    a misspelled option fails with a ``TypeError`` naming the valid set.
    """
    defn = OptimizerDef(name=name, params=dict(params or {}), run=run)
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

# execution routes of the JAX package that are still to be ported
_WAITING_MODES = {
    "batched": "ROADMAP queue 1, item 5",
    "sharded": "ROADMAP queue 1, item 11",
    "served": "ROADMAP queue 1, item 10",
    "async": "ROADMAP queue 1, item 10",
}


def solve(spec: SelectionSpec | Sequence[SelectionSpec], *, mode: str | None = None):
    """Solve one spec (returns a :class:`GreedyResult`), or a sequence of
    specs (returns a list in the same order, each solved sequentially).

    ``mode`` is ``"sequential"`` (the default) — the one route ported so
    far.  The JAX package's other routes raise ``ValueError`` naming the
    ROADMAP item that brings them; their results are bit-identical to the
    sequential route's by contract.
    """
    single = isinstance(spec, SelectionSpec)
    specs = [spec] if single else list(spec)
    for i, s in enumerate(specs):
        if not isinstance(s, SelectionSpec):
            raise TypeError(
                f"solve() takes SelectionSpec objects; item {i} is "
                f"{type(s).__name__!r}"
            )
    mode = "sequential" if mode is None else mode
    if mode in _WAITING_MODES:
        raise ValueError(
            f"mode={mode!r} is not ported to repro_torch yet "
            f"({_WAITING_MODES[mode]}); use mode='sequential'"
        )
    if mode != "sequential":
        raise ValueError(
            f"unknown mode {mode!r}; choose from ['sequential'] "
            f"(still to be ported: {sorted(_WAITING_MODES)})"
        )
    results = [_run_sequential(s) for s in specs]
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


# ---------------------------------------------------------------------------
# Built-in optimizer registrations
# ---------------------------------------------------------------------------

def _naive_run(fn, budget, stop_zero, stop_neg):
    return naive_greedy(fn, budget, stop_zero, stop_neg)


def _lazy_run(fn, budget, stop_zero, stop_neg, *, screen_k):
    return lazy_greedy(fn, budget, screen_k, stop_zero, stop_neg)


register_optimizer("NaiveGreedy", _naive_run)
register_optimizer(
    "LazyGreedy",
    _lazy_run,
    params={"screen_k": Param(8, _int_min(1), "lazy screen width (doubling levels)")},
)
