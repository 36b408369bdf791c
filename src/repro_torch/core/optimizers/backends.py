"""Pluggable gain-sweep backends for the greedy optimizers.

The per-step full sweep — marginal gains for *every* candidate — is where
greedy submodular maximization spends its time (paper §5, Table 3).  This
module decouples *which implementation computes the sweep* from *which
optimizer consumes it*:

- :class:`GainBackend` is the protocol: ``full_sweep(fn, state) -> (n,)``
  plus the optional ``partial_sweep(fn, state, idx) -> (k,)`` gathered form.
- Each :class:`~repro_torch.core.functions.base.SetFunction` may advertise a
  kernel implementation by overriding ``gain_backend()``.
- :func:`register_gain_backend` plugs a backend in for a function class from
  the outside; registry entries win over ``gain_backend()``.
- Optimizers call :func:`full_sweep` / :func:`partial_sweep`, which resolve
  the backend and fall back to the function's plain ``gains()`` /
  ``gains_at()`` PyTorch paths (the ``"torch"`` backend).
- The engines sweep a wave of B functions (the batched engine's members, or
  one function) through :func:`full_sweep_wave` / :func:`partial_sweep_wave`.
  A backend may offer the optional hooks ``full_sweep_wave(fns, states)``
  and ``partial_sweep_wave(fns, states, idx)``, which sweep every member in
  one launch or return None to decline; otherwise each member is swept on
  its own and the rows stacked.

Backend names: the default is ``"torch"``; every backend that runs a
hand-written kernel is named with the prefix ``cuda-`` (``"cuda-fl"`` for
Facility Location, ``"cuda-flmf"`` / ``"cuda-gcmf"`` for the matrix-free
families), so name globs such as ``"cuda-*"`` select them all.

Backend *choice* is pluggable too: functions built with ``use_kernel=None``
defer to :func:`choose_backend`, a decision table over (ground-set size,
budget, device), where the device is that of the function's tensors — an
explicit True/False flag always wins.
"""
from __future__ import annotations

from typing import Callable, Optional, Protocol, runtime_checkable

import torch


@runtime_checkable
class GainBackend(Protocol):
    """A sweep implementation for one function family."""

    name: str

    def full_sweep(self, fn, state) -> torch.Tensor:
        """Marginal gains f(j | A) for every ground element j, shape (n,)."""
        ...

    # Optional protocol extension (resolved via getattr, so plain full-sweep
    # backends keep working):
    #
    # def partial_sweep(self, fn, state, idx) -> torch.Tensor:
    #     """Gains only for the gathered candidate subset ``idx`` (k,)."""


class TorchSweep:
    """Default backend: the function's own vectorized ``gains()``/``gains_at``."""

    name = "torch"

    def full_sweep(self, fn, state) -> torch.Tensor:
        return fn.gains(state)

    def partial_sweep(self, fn, state, idx) -> torch.Tensor:
        return fn.gains_at(state, idx)


_TORCH = TorchSweep()

# class -> factory(fn) -> backend | None; external plug-in point
_REGISTRY: dict[type, Callable[[object], Optional[GainBackend]]] = {}


def register_gain_backend(
    cls: type, factory: Callable[[object], Optional[GainBackend]]
) -> None:
    """Plug a backend factory in for ``cls`` (and subclasses).  The factory
    receives the function instance and may return None to decline."""
    _REGISTRY[cls] = factory


def resolve_backend(fn) -> GainBackend:
    """The backend serving ``fn``'s sweeps: registry entry, else the
    function's own ``gain_backend()``, else the torch fallback."""
    for klass in type(fn).__mro__:
        factory = _REGISTRY.get(klass)
        if factory is not None:
            backend = factory(fn)
            if backend is not None:
                return backend
    hook = getattr(fn, "gain_backend", None)
    backend = hook() if callable(hook) else None
    return _TORCH if backend is None else backend


def full_sweep(fn, state) -> torch.Tensor:
    """Marginal gains for all candidates, routed through the resolved backend."""
    return resolve_backend(fn).full_sweep(fn, state)


def partial_sweep(fn, state, idx) -> torch.Tensor:
    """Marginal gains for the gathered candidate subset ``idx`` only.

    Routed through the resolved backend's ``partial_sweep`` when it has one
    (the gathered-sweep kernels), else the function's ``gains_at`` torch
    path.  Shape follows ``idx``; idx < 0 slots return NEG_INF."""
    return _sweep_at(resolve_backend(fn), fn, state, idx)


def _sweep_at(backend, fn, state, idx) -> torch.Tensor:
    impl = getattr(backend, "partial_sweep", None)
    return fn.gains_at(state, idx) if impl is None else impl(fn, state, idx)


def _wave_hook(backends, name: str):
    """The wave hook ``name`` of the members' backend when every member
    resolved to the same kind of backend, else None."""
    kind = type(backends[0])
    if any(type(b) is not kind for b in backends[1:]):
        return None
    return getattr(backends[0], name, None)


def full_sweep_wave(fns, states) -> torch.Tensor:
    """(B, n) gains of B functions of one shape, each at its own state.  One
    member takes :func:`full_sweep` as it is (no copy); more take their
    backend's wave hook, or one sweep each."""
    if len(fns) == 1:
        return full_sweep(fns[0], states[0])[None]
    backends = [resolve_backend(f) for f in fns]
    hook = _wave_hook(backends, "full_sweep_wave")
    out = None if hook is None else hook(fns, states)
    if out is None:
        out = torch.stack([b.full_sweep(f, s) for b, f, s in zip(backends, fns, states)])
    return out


def partial_sweep_wave(fns, states, idx: torch.Tensor) -> torch.Tensor:
    """(B, k) gains of member b at its candidates ``idx[b]`` (idx (B, k)),
    as :func:`full_sweep_wave` routes them."""
    if len(fns) == 1:
        return partial_sweep(fns[0], states[0], idx[0])[None]
    backends = [resolve_backend(f) for f in fns]
    hook = _wave_hook(backends, "partial_sweep_wave")
    out = None if hook is None else hook(fns, states, idx)
    if out is None:
        out = torch.stack([
            _sweep_at(b, f, s, i) for b, f, s, i in zip(backends, fns, states, idx)
        ])
    return out


def backend_name(fn) -> str:
    """Name of the backend serving ``fn``'s full sweeps ("torch", "cuda-fl", ...)."""
    return getattr(resolve_backend(fn), "name", "torch")


# ---------------------------------------------------------------------------
# Backend choice for use_kernel=None ("auto").
# ---------------------------------------------------------------------------

# Below this ground-set size the kernels are expected to lose to plain torch:
# the sweep fits in cache and launch overhead dominates.  Carried over from
# the JAX package and NOT yet measured on the card: chip_smoke.py prints the
# fl_gains kernel-vs-plain sweep time at n=4096 so that it can be set.
KERNEL_MIN_N = 4096

# Matrix-free sweeps (FacilityLocationMF / GraphCutMF over features)
# recompute the similarity from feature tiles, so a kernel pays off earlier.
# The JAX package's value.  chip_smoke.py times the flmf kernel against the
# torch path at n = 1,024 and 4,096: on the H100 the kernel was ahead at both
# (PERF.md); below 1,024 is not measured yet, so the gate stays.
MF_KERNEL_MIN_N = 1024

# A stateless O(n^2)-streamed sweep (GraphCutMF's cuda-gcmf) recomputes the
# full matrix every step; past this many selection steps the memoized
# O(n)-per-step form wins.  Only callers that know the budget (registry
# factories, schedulers) reach this leg.  The JAX package's value.
KERNEL_MAX_BUDGET_FRACTION = 0.25


def choose_backend(
    n: int,
    budget: int | None = None,
    *,
    device: str | torch.device,
    matrix_free: bool = False,
) -> str:
    """Decision table: "kernel" or "torch" for a function built with
    ``use_kernel=None``.

    - a CPU device -> "torch": the kernels are CUDA kernels;
    - small ground sets (n < KERNEL_MIN_N, or MF_KERNEL_MIN_N for
      ``matrix_free`` sweeps) -> "torch": launch overhead dominates;
    - very large budgets relative to n -> "torch" (pass budget=None for
      memoized-state kernels).

    ``device`` is the device of the function's tensors; nothing here probes
    the machine.
    """
    if torch.device(device).type != "cuda":
        return "torch"
    if n < (MF_KERNEL_MIN_N if matrix_free else KERNEL_MIN_N):
        return "torch"
    if budget is not None and budget > KERNEL_MAX_BUDGET_FRACTION * n:
        return "torch"
    return "kernel"


def kernel_enabled(
    use_kernel: bool | None,
    n: int,
    budget: int | None = None,
    matrix_free: bool = False,
    *,
    device: str | torch.device,
) -> bool:
    """Resolve a family's ``use_kernel`` flag: an explicit True/False always
    wins; None defers to :func:`choose_backend` (manual flag beats heuristic).
    """
    if use_kernel is None:
        return choose_backend(n, budget, device=device, matrix_free=matrix_free) == "kernel"
    return bool(use_kernel)
