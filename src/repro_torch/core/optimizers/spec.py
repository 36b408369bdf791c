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

Ported: every mode of the JAX package (sequential, batched, sharded,
served and async, the last two on a mesh too, under rank 0's control
plane: ``launch/mesh_plane.py``), every optimizer (NaiveGreedy, LazyGreedy,
StochasticGreedy, LazierThanLazyGreedy, and SieveStreaming /
ThresholdGreedy, which register from ``streaming.py``), and the serving
options ``deadline_s`` / ``retry``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional, Sequence

from repro_torch.core.functions.base import SetFunction
from repro_torch.core.optimizers import _threefry
from repro_torch.core.optimizers.greedy import (
    GreedyResult,
    _lazy_bucketed_impl,
    _naive_impl,
    lazier_than_lazy_greedy,
    lazy_greedy,
    member_values,
    naive_greedy,
    stochastic_greedy,
)
from repro_torch.launch.resilience import RetryPolicy

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


def _opt_int_min(lo: int) -> Callable:
    base = _int_min(lo)

    def convert(v):
        return None if v is None else base(v)

    return convert


def _unit_float(v) -> float:
    f = float(v)
    if not 0.0 < f <= 1.0:
        raise ValueError(f"must be a float in (0, 1], got {v!r}")
    return f


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
    and returns a (B, ...) result whose values are each member's value as
    its sequential solve reports it.  ``sharded_run(wave, max_budget,
    budgets, stop_zero, stop_neg, **params)`` runs the same wave over a mesh
    (``wave`` a rank's ``distributed.ShardedWave``, ``budgets`` the B
    budgets) and returns the whole batch's result on every rank.
    ``mesh_replicated`` declares the batched hook valid on a mesh as it is
    (a program sequential in its data pass gives every rank the same
    answer): the streaming optimizers set it.  ``None`` means the optimizer
    cannot ride that route: it is rejected before anything runs.
    """

    name: str
    params: Mapping[str, Param]
    run: Callable
    batched_run: Optional[Callable] = None
    sharded_run: Optional[Callable] = None
    mesh_replicated: bool = False

    @property
    def batched_capable(self) -> bool:
        # every wave may land on a mesh, so a wave needs both routes
        return self.batched_run is not None and (
            self.sharded_run is not None or self.mesh_replicated
        )


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

    ``deadline_s`` is an optional per-request latency budget in seconds
    (positive, finite).  Sequential and batched execution ignore it; the
    async serving scheduler honors it by flushing the request's group no
    later than ``deadline_s`` after submission (a deadline shapes
    *scheduling*, it never changes the selection).

    ``retry`` is an optional :class:`~repro_torch.launch.resilience.
    RetryPolicy` consumed by the serving front doors: transient dispatch
    failures are retried with deterministic backoff, and the request is
    quarantined with a typed ``RequestFailed`` after ``max_attempts`` (its
    ``timeout_s`` is the request's wall-clock budget across attempts).
    Sequential and batched ``solve()`` ignore it.
    """

    fn: object
    budget: int
    optimizer: OptimizerSpec
    stop_if_zero: bool
    stop_if_negative: bool
    use_kernel: Optional[bool]
    deadline_s: Optional[float]
    retry: Optional[RetryPolicy]

    def __init__(
        self,
        fn,
        budget: int,
        optimizer: str | OptimizerSpec = "NaiveGreedy",
        *,
        stopIfZeroGain: bool | None = None,
        stopIfNegativeGain: bool | None = None,
        use_kernel: bool | None = None,
        deadline_s: float | None = None,
        retry: RetryPolicy | None = None,
        **optimizer_params,
    ):
        if not isinstance(fn, SetFunction):
            raise TypeError(
                "SelectionSpec needs a SetFunction instance (e.g. "
                "FacilityLocation.from_kernel(...)); got "
                f"{type(fn).__name__!r}"
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
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if not math.isfinite(deadline_s) or deadline_s <= 0:
                raise ValueError(
                    "deadline_s must be a positive finite number of seconds "
                    f"(or None for no deadline), got {deadline_s!r}"
                )
        if retry is not None and not isinstance(retry, RetryPolicy):
            raise TypeError(
                "retry must be a repro_torch.launch.resilience.RetryPolicy (or "
                f"None for single-attempt semantics), got {type(retry).__name__!r}"
            )
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
        object.__setattr__(self, "deadline_s", deadline_s)
        object.__setattr__(self, "retry", retry)
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
            f"use_kernel={self.use_kernel}"
            + (f", deadline_s={self.deadline_s}" if self.deadline_s else "")
            + (f", retry={self.retry!r}" if self.retry is not None else "")
            + ")"
        )


# ---------------------------------------------------------------------------
# solve(): the one front door
# ---------------------------------------------------------------------------

_MODES = ("sequential", "batched", "sharded", "served", "async")


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
    ``"sequential"`` (the default for one spec; a Python loop for several),
    ``"batched"`` (the default for several: one wave through
    :class:`~repro_torch.core.optimizers.batched.BatchedEngine`; the specs
    must share the optimizer spec and stop rules, and their functions one
    family and shape), ``"sharded"`` (the batched wave over a 2-D ``mesh=``
    from ``distributed.make_mesh``, batch over ``batch_axis`` and candidates
    over ``data_axis``; passing a mesh with the mode unset or batched
    implies it; every rank makes the same call), ``"served"``
    (heterogeneous specs coalesced into padded waves by a
    :class:`~repro_torch.launch.serve.SelectionServer`) or ``"async"``
    (submitted to an :class:`~repro_torch.launch.async_serve.
    AsyncSelectionServer` and awaited).  With ``mesh=`` the served and
    async routes serve on it: every rank makes the same call; rank 0's
    server coalesces and dispatches, the others follow its waves, and
    every rank returns rank 0's results.  ``server`` is an existing server
    of the route's kind to go through (on a mesh, rank 0's; its followers
    run ``server.follow()`` themselves); one is built, and torn down, here
    when it is omitted.  Batched, sharded and served results lie on the host, moved
    there in one transfer per wave.  Every route returns results
    bit-identical to the sequential one by contract.
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
    if mode == "sequential":
        results = [_run_sequential(s) for s in specs]
    elif mode in ("batched", "sharded"):
        if mode == "sharded" and mesh is None:
            raise ValueError('mode="sharded" needs a 2-D mesh= (batch x data)')
        results = _run_batched(specs, mesh=mesh, batch_axis=batch_axis, data_axis=data_axis)
    elif mode == "served":
        results = _run_served(specs, server, mesh=mesh, batch_axis=batch_axis,
                              data_axis=data_axis)
    else:  # async
        results = _run_async(specs, server, mesh=mesh, batch_axis=batch_axis,
                             data_axis=data_axis)
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


def _run_batched(specs, *, mesh, batch_axis, data_axis) -> list[GreedyResult]:
    from repro_torch.core.optimizers.batched import BatchedEngine, wave_hook

    _check_uniform(specs, "sharded" if mesh is not None else "batched")
    head = specs[0]
    # an optimizer without the route's hook raises before stacking or slicing
    wave_hook(head.optimizer.name, mesh is not None)
    engine = BatchedEngine([s.resolved_fn() for s in specs], mesh=mesh, batch_axis=batch_axis,
                           data_axis=data_axis)
    return engine.run(
        [s.budget for s in specs],
        head.optimizer,
        stop_if_zero=head.stop_if_zero,
        stop_if_negative=head.stop_if_negative,
    )


def _mesh_call(server, serve):
    """``serve(server)`` on rank 0 of a mesh server built for this call,
    its results handed to the followers with the stop; a follower returns
    them (or raises rank 0's failure, typed)."""
    from repro_torch.launch.mesh_plane import MeshFailed

    if server.is_follower:
        status, payload = server.follow()
        if status == "ok":
            return payload
        raise MeshFailed(f"rank 0 failed the served call: {payload}")
    try:
        results = serve(server)
    except BaseException as e:
        server.close(("error", f"{type(e).__name__}: {e}"))
        raise
    server.close(("ok", results))
    return results


def _run_served(specs, server, *, mesh, batch_axis, data_axis):
    from repro_torch.launch.serve import SelectionServer

    def serve(srv):
        # select() (not a bare flush) so responses to requests the caller
        # enqueued earlier on their own server are re-held for THEIR next
        # flush() instead of being dropped here
        return [resp.result for resp in srv.select(specs)]

    if server is None and mesh is not None:
        return _mesh_call(SelectionServer(mesh=mesh, batch_axis=batch_axis,
                                          data_axis=data_axis), serve)
    return serve(server if server is not None else SelectionServer())


def _run_async(specs, server, *, mesh, batch_axis, data_axis):
    from repro_torch.launch.async_serve import AsyncSelectionServer
    from repro_torch.launch.serve import SelectionServer

    def serve(front):
        futures = [front.submit(s) for s in specs]
        front.flush_now()
        return [f.result().result for f in futures]

    def serve_closed(srv):
        # the front end wraps srv, so its close() leaves srv open for the stop
        with AsyncSelectionServer(srv) as front:
            return serve(front)

    if server is not None:
        return serve(server)
    if mesh is not None:
        return _mesh_call(SelectionServer(mesh=mesh, batch_axis=batch_axis,
                                          data_axis=data_axis), serve_closed)
    return serve_closed(SelectionServer())


# ---------------------------------------------------------------------------
# Built-in optimizer registrations
# ---------------------------------------------------------------------------

def _naive_run(fn, budget, stop_zero, stop_neg):
    return naive_greedy(fn, budget, stop_zero, stop_neg)


def _naive_batched(fns, max_budget, budgets, valid, stop_zero, stop_neg):
    return _own_values(
        _naive_impl(fns, max_budget, stop_zero, stop_neg, budgets=budgets, valid=valid), budgets
    )


# The sharded hooks import lazily: distributed.py imports the engines this
# module imports, and batched.py imports this module.
def _naive_sharded(wave, max_budget, budgets, stop_zero, stop_neg):
    from repro_torch.core.optimizers.distributed import sharded_batched_greedy

    return sharded_batched_greedy(wave, budgets, max_budget=max_budget, stop_if_zero=stop_zero,
                                  stop_if_negative=stop_neg)


def _own_values(res: GreedyResult, budgets) -> GreedyResult:
    """``res`` with each member's value summed over its own gains
    (:func:`~repro_torch.core.optimizers.greedy.member_values`)."""
    values = member_values(res.gains, budgets.tolist())
    return dataclasses.replace(res, value=values)


def _lazy_run(fn, budget, stop_zero, stop_neg, *, screen_k):
    return lazy_greedy(fn, budget, screen_k, stop_zero, stop_neg)


def _lazy_batched(fns, max_budget, budgets, valid, stop_zero, stop_neg, *, screen_k):
    return _own_values(
        _lazy_bucketed_impl(fns, max_budget, budgets, valid, screen_k, stop_zero, stop_neg),
        budgets,
    )


def _lazy_sharded(wave, max_budget, budgets, stop_zero, stop_neg, *, screen_k):
    from repro_torch.core.optimizers.distributed import sharded_batched_lazy

    return sharded_batched_lazy(wave, budgets, max_budget=max_budget, screen_k=screen_k,
                                stop_if_zero=stop_zero, stop_if_negative=stop_neg)


def _stochastic_run(fn, budget, stop_zero, stop_neg, *, seed, epsilon, sample_size):
    return stochastic_greedy(
        fn, budget, _threefry.prng_key(seed), epsilon, sample_size, stop_zero, stop_neg
    )


def _ltl_run(fn, budget, stop_zero, stop_neg, *, seed, epsilon, sample_size, screen_k):
    return lazier_than_lazy_greedy(
        fn, budget, _threefry.prng_key(seed), epsilon, sample_size, screen_k, stop_zero,
        stop_neg,
    )


_SCREEN_K = Param(8, _int_min(1), "lazy screen width (doubling levels)")
_SAMPLING = {
    "seed": Param(0, _int_min(0), "PRNG seed for the per-step subsample"),
    "epsilon": Param(0.01, _unit_float, "approximation slack in (0, 1]"),
    "sample_size": Param(
        None, _opt_int_min(1), "per-step subsample size (None: from epsilon)"
    ),
}

register_optimizer("NaiveGreedy", _naive_run, batched_run=_naive_batched,
                   sharded_run=_naive_sharded)
register_optimizer(
    "LazyGreedy",
    _lazy_run,
    params={"screen_k": _SCREEN_K},
    batched_run=_lazy_batched,
    sharded_run=_lazy_sharded,
)
# the sampled greedies have no wave hooks, as in the JAX package: the
# serving front doors refuse them at submit time
register_optimizer("StochasticGreedy", _stochastic_run, params=dict(_SAMPLING))
register_optimizer(
    "LazierThanLazyGreedy",
    _ltl_run,
    params={**_SAMPLING, "screen_k": _SCREEN_K},
)

# The streaming optimizers (SieveStreaming / ThresholdGreedy) register
# themselves on import, as in the JAX package: every name above is bound
# when this runs, and streaming.py imports only names of this module.
from repro_torch.core.optimizers import streaming as _streaming  # noqa: E402,F401
