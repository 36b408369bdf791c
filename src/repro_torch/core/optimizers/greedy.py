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

Both are written over a wave of B functions of one shape, with per-member
budgets and a (B, n) ``valid`` mask, for the batched engine
(``batched.py``); the sequential optimizers are their B = 1 case.  Every
step's decisions (mask, argmax, select) are exact per member, and each
member's sweep and update see that member alone, so a member's ids, gains
and ``n_evals`` do not depend on the wave it rides in.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common import NEG_INF
from repro_torch.core.optimizers import _threefry
from repro_torch.core.optimizers.backends import (
    full_sweep,
    full_sweep_wave,
    partial_sweep,
    partial_sweep_wave,
)


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
    if stop_if_zero:  # gj <= 0 covers the negative gains too
        return gj <= 0.0
    if stop_if_negative:
        return gj < 0.0
    return torch.zeros_like(gj, dtype=torch.bool)


def _naive_impl(
    fns,
    max_budget: int,
    stop_if_zero: bool,
    stop_if_negative: bool,
    budgets: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
) -> GreedyResult:
    """NaiveGreedy over a wave of B functions of equal n — the one
    implementation behind :func:`naive_greedy` (B = 1) and the batched
    engine.  ``budgets`` (B,) freezes a member once its budget is spent and
    ``valid`` (B, n) masks padded candidates (NEG_INF, never selected,
    not counted in ``n_evals``); None for either runs the unmasked loop of
    one sequential solve.  Returns (B, max_budget) orders and gains, (B,)
    ``n_evals`` and values."""
    n = fns[0].n
    states = [f.init_state() for f in fns]
    g = full_sweep_wave(fns, states)
    B, dev = len(fns), g.device
    invalid = None if valid is None else ~valid.to(dev)
    # n_evals counts the live candidates of a step
    step_evals = n if valid is None else valid.to(dev).sum(dim=1, keepdim=True, dtype=torch.int32)
    if budgets is not None:
        budgets = budgets.to(dev).reshape(B, 1)
    selected = torch.zeros((B, n), dtype=torch.bool, device=dev)
    order = torch.full((B, max_budget), -1, dtype=torch.int32, device=dev)
    gains = torch.zeros((B, max_budget), dtype=torch.float32, device=dev)
    # (B, 1)-shaped step values: indexing with a 0-d tensor would read it
    # back to the host, so j, gj, take and done stay tensors on the device
    evals = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    done = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    for i in range(max_budget):
        if i:
            g = full_sweep_wave(fns, states)
        g = torch.where(selected if invalid is None else selected | invalid, NEG_INF, g)
        j = torch.argmax(g, dim=1, keepdim=True)  # first-index tie-break
        gj = g.gather(1, j)
        stop = done | _should_stop(gj, stop_if_zero, stop_if_negative)
        frozen = done
        if budgets is not None:  # a member past its budget freezes
            past = budgets <= i
            stop, frozen = stop | past, done | past
        take = ~stop
        states = [
            _where_state(take[b], f.update(s, j[b]), s)
            for b, (f, s) in enumerate(zip(fns, states))
        ]
        selected.scatter_(1, j, selected.gather(1, j) | take)
        order[:, i : i + 1] = torch.where(take, j.to(torch.int32), -1)
        gains[:, i : i + 1] = torch.where(take, gj, 0.0)
        evals += torch.where(frozen, 0, step_evals).to(torch.int32)
        done = stop
    return GreedyResult(order=order, gains=gains, n_evals=evals[:, 0], value=gains.sum(dim=1))


def naive_greedy(
    fn, budget: int, stop_if_zero: bool = True, stop_if_negative: bool = True
) -> GreedyResult:
    """Standard greedy [Nemhauser et al. '78]: full gain sweep per step.
    This is the B = 1 case of ``_naive_impl``."""
    return _first(_naive_impl([fn], budget, stop_if_zero, stop_if_negative))


def member_values(gains: torch.Tensor, budgets) -> torch.Tensor:
    """(B,) values of a wave's (B, max_budget) gains: each member's own
    gains summed in a fresh (1, budget) tensor, as its sequential solve
    sums them (a sum over the wave's longer or offset row may add in
    another order)."""
    return torch.cat([gains[b : b + 1, :bud].clone().sum(dim=1) for b, bud in enumerate(budgets)])


def _first(res: GreedyResult) -> GreedyResult:
    """Member 0 of a wave's result."""
    return GreedyResult(
        order=res.order[0], gains=res.gains[0], n_evals=res.n_evals[0], value=res.value[0]
    )


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
    order (``_screen_levels``) through one gathered ``partial_sweep_wave``
    (one launch for the wave where the backend has a wave hook).  An instance accepts once the best true gain seen beats every
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
    ub = full_sweep_wave(fns, state).to(torch.float32)
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
            g = partial_sweep_wave(fns, state, idx).to(torch.float32)
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
    return _first(_lazy_bucketed_impl(
        [fn],
        budget,
        torch.full((1,), budget, dtype=torch.int32),
        torch.ones((1, fn.n), dtype=torch.bool),
        screen_k,
        stop_if_zero,
        stop_if_negative,
    ))


# ---------------------------------------------------------------------------
# Sampled greedies: StochasticGreedy and LazierThanLazyGreedy
# ---------------------------------------------------------------------------

def _sample_size(n: int, budget: int, epsilon: float, sample_size) -> int:
    """The per-step sample: ``sample_size``, else (n / budget) log(1 /
    epsilon) rounded up and held to [1, n], in Python float arithmetic as
    the JAX package computes it."""
    s = sample_size or max(1, min(n, int(math.ceil(n / budget * math.log(1.0 / epsilon)))))
    if s > n:
        raise ValueError(f"sample_size {s} exceeds the ground set (n = {n})")
    return int(s)


def _draw_keys(mant: torch.Tensor, rev_iota: torch.Tensor) -> torch.Tensor:
    """int64 keys that order a step's uniforms as ``jax.lax.top_k`` orders
    them: the 23 mantissa bits order the uniforms as the floats do, plus
    one to stay above a selected entry's 0, above the reversed index, so
    the keys are distinct and ties go to the lower index, on any device."""
    return ((mant + 1) << 32) | rev_iota


def _sample_unselected(keys: torch.Tensor, selected: torch.Tensor, rev_iota: torch.Tensor,
                       size: int) -> torch.Tensor:
    """``size`` indices in ``jax.lax.top_k`` order of the step's uniforms,
    selected entries (-1 there) at the bottom: the Gumbel top-k subsample of
    the JAX package."""
    return torch.topk(torch.where(selected, rev_iota, keys), size).indices


def _step_keys(key, n: int, budget: int, rev_iota: torch.Tensor, fold: int | None = None):
    """The :func:`_draw_keys` of every step's uniforms ``uniform(fold_in(
    key, i), (n,))`` (with ``fold``, ``fold_in(fold_in(key, i), fold)``'s),
    yielded step by step, drawn a block of steps at a time."""
    block = _threefry.block_steps(n)
    for lo in range(0, budget, block):
        bits = _threefry.step_bits(key, range(lo, min(budget, lo + block)), n, rev_iota.device,
                                   fold)
        yield from _draw_keys(bits >> 9, rev_iota)


def _device_of_state(state):
    """The device of the first tensor of a state's tree."""
    if isinstance(state, torch.Tensor):
        return state.device
    if dataclasses.is_dataclass(state):
        children = [getattr(state, f.name) for f in dataclasses.fields(state)]
    elif isinstance(state, (tuple, list)):
        children = list(state)
    else:
        return None
    for c in children:
        dev = _device_of_state(c)
        if dev is not None:
            return dev
    return None


def stochastic_greedy(
    fn,
    budget: int,
    key=None,
    epsilon: float = 0.01,
    sample_size: int | None = None,
    stop_if_zero: bool = True,
    stop_if_negative: bool = True,
) -> GreedyResult:
    """Stochastic greedy [Mirzasoleiman et al. '15] (paper §5.3.3): each
    step evaluates gains on a random (n/b) log(1/eps) subsample of the
    remaining ground set.  Linear total running time independent of
    budget, 1-1/e-eps in expectation.

    ``key`` is a threefry key (``_threefry.prng_key(seed)``; None: seed 0).
    Step i draws ``uniform(fold_in(key, i), (n,))`` as the JAX package does,
    so the same seed samples the same candidates.  No step waits for the
    card: the loop keeps every decision on the device, as NaiveGreedy does.
    """
    n = fn.n
    key = _threefry.prng_key(0) if key is None else key
    s = _sample_size(n, budget, epsilon, sample_size)
    state = fn.init_state()
    dev = _device_of_state(state)
    rev_iota = 0xFFFFFFFF - torch.arange(n, dtype=torch.int64, device=dev)
    selected = torch.zeros((n,), dtype=torch.bool, device=dev)
    done = torch.zeros((1,), dtype=torch.bool, device=dev)
    picks, picked_gains, takes = [], [], []
    for keys in _step_keys(key, n, budget, rev_iota):
        cand = _sample_unselected(keys, selected, rev_iota, s)
        g = partial_sweep(fn, state, cand).to(torch.float32)
        # sampled entries that are selected (fewer than s unselected left)
        g = torch.where(selected[cand], NEG_INF, g)
        bi = torch.argmax(g, dim=0, keepdim=True)  # first-index tie-break
        j, gj = cand[bi], g[bi]
        stop = done | _should_stop(gj, stop_if_zero, stop_if_negative)
        take = ~stop
        state = _where_state(take, fn.update(state, j), state)
        selected.scatter_(0, j, selected[j] | take)
        picks.append(j)
        picked_gains.append(gj)
        takes.append(take)
        done = stop
    return _sampled_result(picks, picked_gains, takes, s, budget)


def _sampled_result(picks, picked_gains, takes, s: int, budget: int) -> GreedyResult:
    """The result of a sampled greedy's steps: a step that did not take its
    pick holds -1 and gain 0.  Every step up to and including the one that
    stopped evaluated a sample of ``s``."""
    take = torch.cat(takes)
    gains = torch.where(take, torch.cat(picked_gains), 0.0)
    picked = int(take.sum())
    return GreedyResult(
        order=torch.where(take, torch.cat(picks).to(torch.int32), -1),
        gains=gains,
        n_evals=torch.tensor(s * min(budget, picked + 1), dtype=torch.int32, device=take.device),
        value=gains.sum(),
    )


def lazier_than_lazy_greedy(
    fn,
    budget: int,
    key=None,
    epsilon: float = 0.01,
    sample_size: int | None = None,
    screen_k: int = 8,
    stop_if_zero: bool = True,
    stop_if_negative: bool = True,
) -> GreedyResult:
    """Random sampling + lazy evaluation [Mirzasoleiman et al. '15]
    (paper §5.3.4): per step, draw the stochastic-greedy subsample, then
    apply the stale-bound screen *within the sample*, evaluating true gains
    only on the sample's top-``screen_k`` bounds and falling back to the
    whole sample on a bound violation.

    The draws are :func:`stochastic_greedy`'s.  The screen orders the
    sample's bounds as ``jax.lax.top_k`` does (descending, ties to the lower
    position) with a stable sort.  Whether the screen held, and whether its
    pick stops the run, are read back once a step, as the lazy engine reads
    its levels (a second read when the sample is swept).  ``n_evals``
    counts the initial full sweep, then ``screen_k`` or the sample per step.
    """
    n = fn.n
    key = _threefry.prng_key(0) if key is None else key
    s = _sample_size(n, budget, epsilon, sample_size)
    k = min(screen_k, s)
    state = fn.init_state()
    ub = full_sweep(fn, state).to(torch.float32)
    dev = ub.device
    rev_iota = 0xFFFFFFFF - torch.arange(n, dtype=torch.int64, device=dev)
    selected = torch.zeros((n,), dtype=torch.bool, device=dev)
    order = torch.full((budget,), -1, dtype=torch.int32, device=dev)
    gains = torch.zeros((budget,), dtype=torch.float32, device=dev)
    evals = n
    for i, keys in enumerate(_step_keys(key, n, budget, rev_iota)):
        cand = _sample_unselected(keys, selected, rev_iota, s)
        picked = selected[cand]
        ub_cand = torch.where(picked, NEG_INF, ub[cand])
        top_pos = torch.sort(ub_cand, descending=True, stable=True).indices[:k]
        top_idx = cand[top_pos]
        true_g = partial_sweep(fn, state, top_idx).to(torch.float32)
        true_g = torch.where(selected[top_idx], NEG_INF, true_g)
        bi = torch.argmax(true_g, dim=0, keepdim=True)
        rest = ub_cand.index_fill(0, top_pos, NEG_INF)
        ok = true_g[bi] >= rest.amax(dim=0, keepdim=True) - 1e-6
        # one read-back a step: did the screen hold, and would its pick stop?
        screened, stop = torch.cat(
            [ok, _should_stop(true_g[bi], stop_if_zero, stop_if_negative)]).tolist()
        if screened:
            # refresh bounds only for the screened entries; the rest keep
            # their stale (still valid) bounds
            j, gj, cost = top_idx[bi], true_g[bi], k
            upd = ub_cand.index_copy(0, top_pos, true_g)
        else:
            upd = torch.where(picked, NEG_INF, partial_sweep(fn, state, cand).to(torch.float32))
            b = torch.argmax(upd, dim=0, keepdim=True)
            j, gj, cost = cand[b], upd[b], s
            stop = bool(_should_stop(gj, stop_if_zero, stop_if_negative))
        ub[cand] = upd
        evals += cost
        if stop:
            break  # the step that stops takes nothing; nothing changes after it
        state = fn.update(state, j)
        selected[j] = True
        order[i : i + 1] = j.to(torch.int32)
        gains[i : i + 1] = gj
    return GreedyResult(order=order, gains=gains,
                        n_evals=torch.tensor(evals, dtype=torch.int32, device=dev),
                        value=gains.sum())
