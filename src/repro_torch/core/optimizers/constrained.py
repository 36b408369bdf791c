"""Problem 2 (Submodular Cover) and constrained greedy variants (paper §2).

cover_greedy:    min |X| (or cost) s.t. f(X) >= c        [Wolsey '82]
knapsack_greedy: max f(X) s.t. sum cost <= b             [Sviridenko '04,
                 cost-ratio rule + best-feasible-singleton safeguard]
matroid_greedy:  max f(X) s.t. X independent in a partition matroid
                 [Fisher/Nemhauser/Wolsey '78 — 1/2 guarantee]

The declarative side — :class:`Knapsack` and :class:`PartitionMatroid` —
are hashable frozen dataclasses, so a constraint rides an
:class:`~repro_torch.core.optimizers.spec.OptimizerSpec` as static
metadata (and so is part of the serving coalescer's group key).  The
streaming optimizers (``optimizers/streaming.py``) consume them through
``streaming_state`` / ``streaming_feasible`` / ``streaming_add``, so
constrained streaming is a spec flag, not a forked accept rule.

The arithmetic is the JAX package's, in fp32: spent cost, cost ratios and
``value >= coverage`` are fp32 there, so a knife-edge feasibility test
decides alike.  The greedies keep every decision on the device and read
back one flag a step, to stop sweeping once their stop rule has fired
(the JAX package's fixed-length loop changes nothing after it).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common import NEG_INF, as_float_tensor
from repro_torch.core.optimizers.backends import full_sweep
from repro_torch.core.optimizers.greedy import GreedyResult, _where_state


# ---------------------------------------------------------------------------
# Declarative constraints (static spec metadata)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Knapsack:
    """``sum(costs[j] for j in X) <= budget`` — item costs must be positive.

    ``costs`` is indexed by ground-set position; hashable (tuples only), so
    it can be an OptimizerSpec hyperparameter.
    """

    costs: tuple
    budget: float

    def __post_init__(self):
        costs = tuple(float(c) for c in self.costs)
        if not costs:
            raise ValueError("Knapsack needs at least one item cost")
        if any(c <= 0 for c in costs):
            raise ValueError("Knapsack costs must all be positive")
        budget = float(self.budget)
        if budget <= 0:
            raise ValueError(f"Knapsack budget must be positive, got {budget}")
        object.__setattr__(self, "costs", costs)
        object.__setattr__(self, "budget", budget)


@dataclasses.dataclass(frozen=True)
class PartitionMatroid:
    """At most ``caps[p]`` picks from each part: ``labels[j]`` names item
    j's part, ``caps`` the per-part capacities.  Hashable static metadata,
    like :class:`Knapsack`."""

    labels: tuple
    caps: tuple

    def __post_init__(self):
        labels = tuple(int(p) for p in self.labels)
        caps = tuple(int(c) for c in self.caps)
        if not caps:
            raise ValueError("PartitionMatroid needs at least one part cap")
        if any(c < 0 for c in caps):
            raise ValueError("PartitionMatroid caps must be >= 0")
        if labels and not all(0 <= p < len(caps) for p in labels):
            raise ValueError(
                f"PartitionMatroid labels must index caps (0..{len(caps) - 1})"
            )
        object.__setattr__(self, "labels", labels)
        object.__setattr__(self, "caps", caps)


def as_constraint(v):
    """Validate an optimizer-spec ``constraint`` value (None passes through).

    The converter behind the streaming optimizers' ``constraint``
    hyperparameter — anything else raises ``TypeError`` naming the accepted
    forms."""
    if v is None or isinstance(v, (Knapsack, PartitionMatroid)):
        return v
    raise TypeError(
        "constraint must be None, a Knapsack, or a PartitionMatroid "
        f"(repro_torch.core.optimizers.constrained); got {type(v).__name__!r}"
    )


# -- accept-rule hooks (a None constraint makes them no-ops) -----------------

def _table(values, dtype, device, j) -> torch.Tensor:
    """``values[j]`` of a constraint's tuple; ``j`` past its end reads the
    last entry, as the JAX package's clamped gather does."""
    t = torch.tensor(values, dtype=dtype, device=device)
    j = torch.as_tensor(j, device=device).to(torch.int64)
    return t[torch.clamp(j, 0, len(values) - 1)]


def streaming_state(constraint, width: int, device=None) -> torch.Tensor:
    """Per-selector feasibility state, ``width`` independent selectors
    (sieves): spent cost for a knapsack, per-part counts for a matroid, a
    placeholder when unconstrained."""
    if isinstance(constraint, PartitionMatroid):
        return torch.zeros((width, len(constraint.caps)), dtype=torch.int32, device=device)
    return torch.zeros((width,), dtype=torch.float32, device=device)


def streaming_feasible(constraint, cstate, j) -> torch.Tensor:
    """(width,) bool: may element ``j`` join each selector right now?  With
    one selector (``cstate`` of width 1) and a vector ``j``, one entry per
    element instead."""
    if constraint is None:
        n = cstate.shape[0] if torch.as_tensor(j).dim() == 0 else torch.as_tensor(j).numel()
        return torch.ones((n,), dtype=torch.bool, device=cstate.device)
    if isinstance(constraint, Knapsack):
        cost = _table(constraint.costs, torch.float32, cstate.device, j)
        return cstate + cost <= torch.tensor(constraint.budget, dtype=torch.float32,
                                              device=cstate.device)
    lab = _table(constraint.labels, torch.int64, cstate.device, j)
    cap = _table(constraint.caps, torch.int32, cstate.device, lab)
    return cstate[:, lab].reshape(-1) < cap


def streaming_add(constraint, cstate, j, accept) -> torch.Tensor:
    """Charge element ``j`` to the selectors where ``accept`` is True."""
    if constraint is None:
        return cstate
    accept = torch.as_tensor(accept, device=cstate.device)
    if isinstance(constraint, Knapsack):
        cost = _table(constraint.costs, torch.float32, cstate.device, j)
        return cstate + torch.where(accept, cost, 0.0)
    lab = _table(constraint.labels, torch.int64, cstate.device, j)
    out = cstate.clone()
    out[:, lab] += accept.to(torch.int32)
    return out


class HostFeasibility:
    """One selector's accept test and charge for a constraint, on the host
    in numpy, in the JAX package's fp32 / int32 arithmetic (an index past
    the constraint's table reads its last entry, as that package's clamped
    gather does): the streaming engines' form of ``streaming_feasible`` /
    ``streaming_add``, over a window of elements at once."""

    def __init__(self, constraint):
        self.constraint = constraint
        if isinstance(constraint, Knapsack):
            self.costs = np.asarray(constraint.costs, np.float32)
            self.budget = np.float32(constraint.budget)
        elif isinstance(constraint, PartitionMatroid):
            self.labels = np.asarray(constraint.labels, np.int64)
            self.caps = np.asarray(constraint.caps, np.int32)

    def init(self):
        if isinstance(self.constraint, PartitionMatroid):
            return np.zeros(len(self.caps), np.int32)
        return np.float32(0.0)

    def ok(self, cstate, ids: np.ndarray) -> np.ndarray:
        if self.constraint is None:
            return np.ones(ids.shape, bool)
        if isinstance(self.constraint, Knapsack):
            cost = self.costs[np.minimum(ids, len(self.costs) - 1)]
            return (cstate + cost) <= self.budget
        lab = self.labels[np.minimum(ids, len(self.labels) - 1)]
        return cstate[lab] < self.caps[lab]

    def add(self, cstate, j: int):
        if isinstance(self.constraint, Knapsack):
            return np.float32(cstate + self.costs[min(j, len(self.costs) - 1)])
        if isinstance(self.constraint, PartitionMatroid):
            cstate = cstate.copy()
            cstate[self.labels[min(j, len(self.labels) - 1)]] += 1
        return cstate


# ---------------------------------------------------------------------------
# Offline constrained greedies
# ---------------------------------------------------------------------------

def _costs(costs, n: int, device) -> torch.Tensor:
    if costs is None:
        return torch.ones((n,), dtype=torch.float32, device=device)
    return as_float_tensor(costs, device)


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(torch.float32).reshape(1)


def cover_greedy(fn, coverage, max_steps: int, costs=None) -> GreedyResult:
    """Greedily add the max gain-per-cost element until f(X) >= coverage.
    ``value`` is the fp32 running sum the stop rule reads."""
    n = fn.n
    state = fn.init_state()
    g = full_sweep(fn, state)
    dev = g.device
    costs_arr = _costs(costs, n, dev)
    coverage = _scalar(coverage, dev)
    selected = torch.zeros((n,), dtype=torch.bool, device=dev)
    order = torch.full((max_steps,), -1, dtype=torch.int32, device=dev)
    gains = torch.zeros((max_steps,), dtype=torch.float32, device=dev)
    value = torch.zeros((1,), dtype=torch.float32, device=dev)
    done = torch.zeros((1,), dtype=torch.bool, device=dev)
    for i in range(max_steps):
        if i:
            if bool(done):  # nothing changes once stopped
                break
            g = full_sweep(fn, state)
        g = torch.where(selected, NEG_INF, g.to(torch.float32))
        j = torch.argmax(g / costs_arr, dim=0, keepdim=True)
        gj = g[j]
        stop = done | (value >= coverage) | (gj <= 0.0)
        take = ~stop
        state = _where_state(take, fn.update(state, j), state)
        selected.scatter_(0, j, selected[j] | take)
        order[i : i + 1] = torch.where(take, j.to(torch.int32), -1)
        gains[i : i + 1] = torch.where(take, gj, 0.0)
        value = value + torch.where(take, gj, 0.0)
        done = stop
    return GreedyResult(order=order, gains=gains, n_evals=_evals(max_steps, n, dev),
                        value=value[0])


def _evals(max_steps: int, n: int, device) -> torch.Tensor:
    # int32, as the JAX package counts it
    return torch.tensor(max_steps * n, dtype=torch.int64).to(torch.int32).to(device)


def knapsack_greedy(fn, budget, max_steps: int, costs=None) -> GreedyResult:
    """Cost-ratio greedy under a knapsack budget sum(cost) <= b."""
    n = fn.n
    state = fn.init_state()
    g = full_sweep(fn, state)
    dev = g.device
    costs_arr = _costs(costs, n, dev)
    budget = _scalar(budget, dev)
    selected = torch.zeros((n,), dtype=torch.bool, device=dev)
    spent = torch.zeros((1,), dtype=torch.float32, device=dev)
    order = torch.full((max_steps,), -1, dtype=torch.int32, device=dev)
    gains = torch.zeros((max_steps,), dtype=torch.float32, device=dev)
    done = torch.zeros((1,), dtype=torch.bool, device=dev)
    for i in range(max_steps):
        if i:
            if bool(done):  # nothing changes once stopped
                break
            g = full_sweep(fn, state)
        g = g.to(torch.float32)
        feasible = (~selected) & (spent + costs_arr <= budget)
        j = torch.argmax(torch.where(feasible, g / costs_arr, NEG_INF), dim=0, keepdim=True)
        gj = g[j]
        stop = done | ~feasible[j] | (gj <= 0.0)
        take = ~stop
        state = _where_state(take, fn.update(state, j), state)
        selected.scatter_(0, j, selected[j] | take)
        spent = spent + torch.where(take, costs_arr[j], 0.0)
        order[i : i + 1] = torch.where(take, j.to(torch.int32), -1)
        gains[i : i + 1] = torch.where(take, gj, 0.0)
        done = stop
    return GreedyResult(order=order, gains=gains, n_evals=_evals(max_steps, n, dev),
                        value=gains.sum())


def matroid_greedy(fn, constraint: PartitionMatroid, max_steps: int) -> GreedyResult:
    """Greedy under a partition matroid: each step adds the max-gain element
    whose part still has capacity (1/2-approximate for monotone f
    [Fisher/Nemhauser/Wolsey '78])."""
    n = fn.n
    state = fn.init_state()
    g = full_sweep(fn, state)
    dev = g.device
    labels = torch.tensor(constraint.labels, dtype=torch.int64, device=dev)
    caps = torch.tensor(constraint.caps, dtype=torch.int32, device=dev)
    selected = torch.zeros((n,), dtype=torch.bool, device=dev)
    counts = torch.zeros((len(constraint.caps),), dtype=torch.int32, device=dev)
    order = torch.full((max_steps,), -1, dtype=torch.int32, device=dev)
    gains = torch.zeros((max_steps,), dtype=torch.float32, device=dev)
    done = torch.zeros((1,), dtype=torch.bool, device=dev)
    for i in range(max_steps):
        if i:
            if bool(done):  # nothing changes once stopped
                break
            g = full_sweep(fn, state)
        feasible = (~selected) & (counts[labels] < caps[labels])
        g = torch.where(feasible, g.to(torch.float32), NEG_INF)
        j = torch.argmax(g, dim=0, keepdim=True)
        gj = g[j]
        stop = done | ~feasible[j] | (gj <= 0.0)
        take = ~stop
        state = _where_state(take, fn.update(state, j), state)
        selected.scatter_(0, j, selected[j] | take)
        counts.scatter_add_(0, labels[j], take.to(torch.int32))
        order[i : i + 1] = torch.where(take, j.to(torch.int32), -1)
        gains[i : i + 1] = torch.where(take, gj, 0.0)
        done = stop
    return GreedyResult(order=order, gains=gains, n_evals=_evals(max_steps, n, dev),
                        value=gains.sum())
