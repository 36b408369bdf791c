"""Greedy maximizers (paper §5.3).

All optimizers return a :class:`GreedyResult` with a fixed-size ``order``
buffer (-1 padded once stopping criteria fire), the per-step gains, and the
number of marginal-gain evaluations performed (the hardware-independent cost
metric used to reproduce the paper's Table 2 ordering).

Tie-breaking matches the paper: the *first* best element is added.

Both engines run a fixed-length loop of ``budget`` steps with a ``done``
flag, as the JAX package's ``fori_loop`` does, and keep every decision on
the device: NaiveGreedy never waits for the card inside its loop.  The lazy
engine's level schedule is the one exception (see ``_lazy_bucketed_impl``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import NEG_INF
from repro_torch.core.optimizers.backends import full_sweep, partial_sweep


@dataclasses.dataclass(frozen=True, eq=False)
class GreedyResult:
    order: torch.Tensor  # (budget,) int32 selected indices, -1 once stopped
    gains: torch.Tensor  # (budget,) fp32 marginal gains (0 once stopped)
    n_evals: torch.Tensor  # int32 total marginal-gain evaluations
    value: torch.Tensor  # f(A) of the returned set (telescoped gains)

    def as_list(self):
        """[(index, gain), ...] like submodlib's maximize() return value."""
        order = self.order.cpu().tolist()
        gains = self.gains.cpu().tolist()
        return [(int(i), float(g)) for i, g in zip(order, gains) if i >= 0]


def _where_state(pred, new, old):
    """Select ``new`` where the scalar/row predicate holds, leaf by leaf over
    the state's tree, as ``jax.tree.map`` does in the JAX package: a state
    is a tensor, a dataclass of fields, or a tuple / list of states (the
    difference combinator's pair); non-tensor leaves (static ints) keep
    ``old``'s value."""
    if isinstance(old, torch.Tensor):
        if old.dim() < pred.dim():  # a 0-d leaf under a one-element predicate
            p = pred.reshape(old.shape)
        else:
            p = pred.reshape(pred.shape + (1,) * (old.dim() - pred.dim()))
        return torch.where(p, new, old)
    if dataclasses.is_dataclass(old):
        return type(old)(**{
            f.name: _where_state(pred, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(old)
        })
    if isinstance(old, (tuple, list)):
        return type(old)(_where_state(pred, a, b) for a, b in zip(new, old))
    return old


def _should_stop(gj, stop_if_zero: bool, stop_if_negative: bool):
    stop = torch.zeros_like(gj, dtype=torch.bool)
    if stop_if_zero:
        stop |= gj <= 0.0
    if stop_if_negative:
        stop |= gj < 0.0
    return stop


def _naive_impl(fn, budget: int, stop_if_zero: bool, stop_if_negative: bool) -> GreedyResult:
    n = fn.n
    state = fn.init_state()
    g = full_sweep(fn, state)
    dev = g.device
    selected = torch.zeros((n,), dtype=torch.bool, device=dev)
    order = torch.full((budget,), -1, dtype=torch.int32, device=dev)
    gains = torch.zeros((budget,), dtype=torch.float32, device=dev)
    # (1,)-shaped step values: indexing with a 0-d tensor would read it
    # back to the host, so j, gj, take and done stay one-element tensors
    evals = torch.zeros((1,), dtype=torch.int32, device=dev)
    done = torch.zeros((1,), dtype=torch.bool, device=dev)
    for i in range(budget):
        if i:
            g = full_sweep(fn, state)
        g = torch.where(selected, NEG_INF, g)
        j = torch.argmax(g, dim=0, keepdim=True)  # first-index tie-break
        gj = g.gather(0, j)
        stop = done | _should_stop(gj, stop_if_zero, stop_if_negative)
        take = ~stop
        state = _where_state(take, fn.update(state, j), state)
        selected.scatter_(0, j, selected.gather(0, j) | take)
        order[i : i + 1] = torch.where(take, j.to(torch.int32), -1)
        gains[i : i + 1] = torch.where(take, gj, 0.0)
        evals += torch.where(done, 0, n).to(torch.int32)
        done = stop
    return GreedyResult(order=order, gains=gains, n_evals=evals[0], value=gains.sum())


def naive_greedy(
    fn, budget: int, stop_if_zero: bool = True, stop_if_negative: bool = True
) -> GreedyResult:
    """Standard greedy [Nemhauser et al. '78]: full gain sweep per step."""
    return _naive_impl(fn, budget, stop_if_zero, stop_if_negative)


def _screen_levels(n: int, screen_k: int) -> tuple[tuple[int, int], ...]:
    """Static (lo, hi) slices of the per-step stale-bound sort: cumulative
    screen widths screen_k, 2*screen_k, 4*screen_k, ..., capped at n.

    The last level always reaches n, so every step resolves within the
    schedule and each candidate is evaluated at most once per step — the
    per-step eval cost is <= n (a naive sweep) with equality only on a full
    bound-screen miss."""
    levels, lo = [], 0
    hi = min(max(int(screen_k), 1), n)
    while True:
        levels.append((lo, hi))
        if hi >= n:
            return tuple(levels)
        lo, hi = hi, min(2 * hi, n)


def _lazy_bucketed_impl(
    fns,
    max_budget: int,
    budgets: torch.Tensor,
    valid: torch.Tensor,
    screen_k: int,
    stop_if_zero: bool,
    stop_if_negative: bool,
) -> GreedyResult:
    """Bucketed lazy greedy over a batch of B functions of equal n — the
    one implementation behind :func:`lazy_greedy` (B = 1), written with an
    explicit batch dimension so the batched engine can reuse it.

    ``fns`` is a sequence of B functions; ``budgets`` (B,) int and ``valid``
    (B, n) bool are tensors, moved to the functions' device.

    Per step, candidates are sorted by stale upper bound (descending, ties
    broken by lowest index) and evaluated in doubling *levels* of that
    order (``_screen_levels``) through one gathered ``partial_sweep`` per
    member.  An instance accepts once the best true gain seen beats every
    remaining stale bound (``best >= rest - 1e-6``); the last level spans
    all n, so a full miss degenerates to exactly one evaluation per
    candidate.  The winner is the first-index argmax over evaluated gains.
    ``n_evals`` counts, per instance, the live candidates of the levels that
    instance was still unresolved for, plus the initial bound sweep.

    Host sync: whether a level runs at all depends on whether every
    instance has resolved, and that is read back with one ``.item()`` per
    level after the first.  It is the one host sync per level this engine
    accepts; everything else stays on the device.
    """
    B, n = valid.shape
    levels = _screen_levels(n, screen_k)
    state = [f.init_state() for f in fns]
    ub = torch.stack([full_sweep(f, s) for f, s in zip(fns, state)]).to(torch.float32)
    dev = ub.device
    budgets, valid = budgets.to(dev), valid.to(dev)
    rows = torch.arange(B, device=dev)
    selected = torch.zeros((B, n), dtype=torch.bool, device=dev)
    order = torch.full((B, max_budget), -1, dtype=torch.int32, device=dev)
    gains = torch.zeros((B, max_budget), dtype=torch.float32, device=dev)
    evals = valid.sum(dim=1, dtype=torch.int32)  # the initial bound sweep
    done = torch.zeros((B,), dtype=torch.bool, device=dev)

    for i in range(max_budget):
        blocked = selected | ~valid
        ubm = torch.where(blocked, NEG_INF, ub)
        # descending stale-bound order, ties by lowest index: a stable
        # ascending sort of -ub (the JAX package sorts (-ub, index))
        neg_sv, si = torch.sort(-ubm, dim=1, stable=True)
        sv = -neg_sv

        resolved = torch.zeros((B,), dtype=torch.bool, device=dev)
        geval = torch.full((B, n), NEG_INF, dtype=torch.float32, device=dev)
        evaluated = torch.zeros((B, n), dtype=torch.bool, device=dev)
        cost = torch.zeros((B,), dtype=torch.int32, device=dev)
        for lo, hi in levels:
            # the one host sync per level: skip the rest once all resolved
            if lo > 0 and bool(resolved.all()):
                break
            idx = si[:, lo:hi]  # (B, hi - lo)
            g = torch.stack(
                [partial_sweep(f, s, idx[b]) for b, (f, s) in enumerate(zip(fns, state))]
            ).to(torch.float32)
            g = torch.where(torch.gather(blocked, 1, idx), NEG_INF, g)
            live = ~resolved  # instances this level still works for
            geval = torch.where(live[:, None], geval.scatter(1, idx, g), geval)
            evaluated = torch.where(
                live[:, None], evaluated.scatter(1, idx, True), evaluated
            )
            # logical evaluations only: pad candidates are not oracle calls
            w_valid = torch.gather(valid, 1, idx).sum(dim=1, dtype=torch.int32)
            cost = cost + torch.where(live, w_valid, 0)
            best = geval.amax(dim=1)
            # largest stale bound not yet evaluated
            rest = sv[:, hi] if hi < n else torch.full((B,), NEG_INF, device=dev)
            resolved = resolved | (best >= rest - 1e-6)

        j = torch.argmax(geval, dim=1)  # first-index tie-break, like naive
        gj = geval[rows, j]
        past = i >= budgets
        stop = done | past | _should_stop(gj, stop_if_zero, stop_if_negative)
        take = ~stop
        state = [
            _where_state(take[b : b + 1], f.update(s, j[b : b + 1]), s)
            for b, (f, s) in enumerate(zip(fns, state))
        ]
        selected[rows, j] |= take
        ub = torch.where(evaluated, geval, ubm)  # refreshed bounds stay valid
        order[:, i] = torch.where(take, j.to(torch.int32), -1)
        gains[:, i] = torch.where(take, gj, 0.0)
        evals += torch.where(done | past, 0, cost)
        done = stop

    return GreedyResult(order=order, gains=gains, n_evals=evals, value=gains.sum(dim=1))


def lazy_greedy(
    fn,
    budget: int,
    screen_k: int = 8,
    stop_if_zero: bool = True,
    stop_if_negative: bool = True,
) -> GreedyResult:
    """Bound-screened greedy — Minoux's accelerated (lazy) greedy
    [paper §5.3.2] with a dense vector of stale upper bounds in place of the
    priority queue (valid by submodularity: gains only shrink as A grows).

    Each step re-evaluates true gains for the candidates with the largest
    stale bounds in doubling screen levels (screen_k, 2*screen_k, ...),
    accepting as soon as the best evaluated gain beats every remaining stale
    bound.  Identical output to naive_greedy, far fewer gain evaluations on
    peaked gain distributions.  This is the B = 1 case of
    ``_lazy_bucketed_impl``.
    """
    res = _lazy_bucketed_impl(
        [fn],
        budget,
        torch.full((1,), budget, dtype=torch.int32),
        torch.ones((1, fn.n), dtype=torch.bool),
        screen_k,
        stop_if_zero,
        stop_if_negative,
    )
    return GreedyResult(
        order=res.order[0], gains=res.gains[0], n_evals=res.n_evals[0], value=res.value[0]
    )
