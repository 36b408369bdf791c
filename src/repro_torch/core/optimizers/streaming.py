"""Single-pass streaming maximizers (online selection).

Two registry optimizers for candidate streams, both riding the normal
``SelectionSpec`` / ``solve()`` front door, the server and its sessions:

- **SieveStreaming** [Badanidiyuru et al. '14]: one pass over the arrival
  order, a geometric ladder of thresholds v = (1+eps)^i maintained over the
  running max-singleton estimate m (m <= v <= 2*budget*m), one sieve per
  live threshold.  An arrival e joins sieve S_v when |S_v| < k and
  f(e | S_v) >= (v/2 - f(S_v)) / (k - |S_v|); the best sieve wins.  For
  monotone submodular f this guarantees f >= (1/2 - eps) * OPT.

- **ThresholdGreedy** [Badanidiyuru & Vondrak '14, buffered]: arrivals are
  buffered into chunks of ``buffer_size``; each chunk first raises the
  running max-singleton estimate d, then is swept by a fixed descending
  ladder tau = d*(1-eps)^l (down to eps*d/n), accepting any element whose
  gain clears the current rung.

The JAX package runs each as one long loop of single-arrival steps (n steps
with an L-rung sweep each for the sieve, C*(L+1)*buffer_size steps with two
one-element sweeps each for the threshold ladder).  The port makes the same
decisions from far fewer sweeps, relying on one contract: a gathered
sweep's value at an index does not depend on which other indices are swept
with it (``local_gathers`` on the function or its kernel backend).  Then:

- the singleton probes are gains at the empty state: one sweep over the
  arrivals, read in arrival order;
- the running maximum (m, d) is a cumulative max over them, so every
  arrival's rung window, slot reset and live count are known up front, and
  so is ``n_evals``, which stays the JAX package's logical count (one
  singleton probe per valid arrival plus one gain per live rung for the
  sieve; per visit for the threshold ladder);
- between two accepts of one sieve, or within one threshold pass, the
  state and the threshold are fixed.  So the engine sweeps a window of the
  next arrivals against that state in one call, takes the first that passes
  every condition of the accept rule, updates, and sweeps on from the next
  arrival.  A sieve that holds nothing yet reads the singleton probes.

Each decision is the JAX package's own.  The sieves share one function, so
the rungs ride the member axis of the backend's wave sweep (the dense FL
kernel takes them as a member-stride-0 view of one S, one launch a
window).  A function whose gathered sweeps are not index-local sweeps one
arrival at a time, as the JAX package does.  The ladders are fp32, with
the JAX package's ``exp`` / ``log`` (``_fp32.py``), and the seeded arrival
order draws the JAX package's ``fold_in`` uniforms (``_threefry.py``).

Rungs are identified by their index, never by a slot: the JAX package's
static ring of L slots resets a rung's sieve whenever the rung leaves the
ring's window and re-enters it, and the engine tracks exactly those
lifetimes.  Padded arrivals (``valid`` False) sort last and cost nothing,
and a wave runs its members one after another, so a served member equals
its sequential solve bit for bit.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core.optimizers import _threefry
from repro_torch.core.optimizers._fp32 import exp32, log32, recip32
from repro_torch.core.optimizers.backends import _sweep_at, local_gathers, resolve_backend
from repro_torch.core.optimizers.constrained import HostFeasibility, as_constraint
from repro_torch.core.optimizers.greedy import GreedyResult, _device_of_state, member_values
from repro_torch.core.optimizers.spec import Param, _int_min, _opt_int_min, register_optimizer

__all__ = ["sieve_streaming", "threshold_greedy"]

# window of arrivals a sieve sweeps after an accept; it doubles on every
# window without one, up to _WINDOW_MAX (below the gathered FL kernel's
# full-sweep crossover at n = 50,000)
_WINDOW_MIN = 32
_WINDOW_MAX = 1024
# arrivals per window of the threshold ladder's passes, at most
_CHUNK_WINDOW_MAX = 4096


def _ladder_eps(v) -> float:
    f = float(v)
    if not 0.0 < f < 1.0:
        raise ValueError(f"must be a float in (0, 1), got {v!r}")
    return f


def _arrival_order(valid: torch.Tensor, seed) -> torch.Tensor:
    """(n,) arrival permutation: valid items first, invalid last.

    ``seed=None`` keeps index order; an int seed shuffles by per-index
    ``fold_in`` uniforms (ties by index), so the relative order of the
    valid items does not depend on how far the instance was padded."""
    n = valid.shape[0]
    if seed is None:
        primary = torch.where(valid, 0.0, 2.0)
    else:
        u = _threefry.fold_in_uniforms(_threefry.prng_key(seed), n, valid.device)
        primary = torch.where(valid, u, 2.0)
    return torch.sort(primary, stable=True).indices


# ---------------------------------------------------------------------------
# Sweeps: windows of arrivals against one or several states
# ---------------------------------------------------------------------------

class _Sweeper:
    """Gains of windows of arrival ids against states of one function, on
    its resolved backend: several states through the backend's wave hook
    in one launch where it has one (the windows padded with -1), else one
    gathered sweep each; one arrival per sweep where the gathers are not
    index-local.  The windows go to the device in one copy, the gains come
    back to the host in one."""

    def __init__(self, fn, device):
        self.fn, self.device = fn, device
        self.backend = resolve_backend(fn)
        self.local = local_gathers(fn, self.backend)
        self.hook = getattr(self.backend, "partial_sweep_wave", None)

    def _one(self, state, ids: torch.Tensor) -> torch.Tensor:
        if self.local or ids.numel() <= 1:
            return _sweep_at(self.backend, self.fn, state, ids).to(torch.float32)
        return torch.cat([
            _sweep_at(self.backend, self.fn, state, ids[i : i + 1]).to(torch.float32)
            for i in range(ids.numel())
        ])

    def sweep(self, states, windows) -> list[np.ndarray]:
        """``windows[i]``, an int64 array of ids, swept at ``states[i]``."""
        sizes = [w.shape[0] for w in windows]
        if self.local and self.hook is not None and len(states) > 1:
            idx = np.full((len(windows), max(sizes)), -1, np.int64)
            for i, w in enumerate(windows):
                idx[i, : w.shape[0]] = w
            rows = self.hook([self.fn] * len(states), list(states),
                             torch.from_numpy(idx).to(self.device))
            if rows is not None:
                rows = rows.to(torch.float32).cpu().numpy()
                return [rows[i, :k] for i, k in enumerate(sizes)]
        flat = torch.from_numpy(np.concatenate(windows)).to(self.device)
        parts = torch.split(flat, sizes)
        out = torch.cat([self._one(s, w) for s, w in zip(states, parts)]).cpu().numpy()
        return np.split(out, np.cumsum(sizes)[:-1])


def _probe(sweeper: _Sweeper, state0, ids: np.ndarray) -> np.ndarray:
    """The singleton gains of the arrivals ``ids`` at the empty state."""
    if ids.shape[0] == 0:
        return np.zeros((0,), np.float32)
    return sweeper.sweep([state0], [ids])[0]


def _passes(g: np.ndarray, stop_zero: bool, stop_neg: bool) -> np.ndarray:
    """Where the stop rules let a gain be accepted."""
    ok = np.ones(g.shape, bool)
    if stop_zero:
        ok &= ~(g <= 0.0)
    if stop_neg:
        ok &= ~(g < 0.0)
    return ok


def _result(order, gains, n_evals: int, value, budget: int, device) -> GreedyResult:
    out_order = torch.full((budget,), -1, dtype=torch.int32)
    out_gains = torch.zeros((budget,), dtype=torch.float32)
    if order:
        out_order[: len(order)] = torch.tensor(order, dtype=torch.int32)
        out_gains[: len(gains)] = torch.from_numpy(np.asarray(gains, np.float32))
    if value is None:  # the telescoped gains, summed as a wave member's are
        value = member_values(out_gains[None], [budget])[0]
    return GreedyResult(
        order=out_order.to(device),
        gains=out_gains.to(device),
        n_evals=torch.tensor(n_evals, dtype=torch.int64).to(torch.int32).to(device),
        value=torch.as_tensor(value, dtype=torch.float32).to(device),
    )


def _stream_setup(fn, valid, seed):
    """(sweeper, empty state, device, the valid arrivals' ids in arrival
    order on the host, their singleton gains)."""
    state0 = fn.init_state()
    dev = _device_of_state(state0) or torch.device("cpu")
    valid = torch.as_tensor(valid).to(device=dev, dtype=torch.bool)
    ids = _arrival_order(valid, seed)[: int(valid.sum())].cpu().numpy()
    sweeper = _Sweeper(fn, dev)
    return sweeper, state0, dev, ids, _probe(sweeper, state0, ids)


def _one_id(j: int, device) -> torch.Tensor:
    return torch.tensor([j], dtype=torch.int64, device=device)


def _stack(results: list[GreedyResult], max_budget: int) -> GreedyResult:
    """A wave's (B, max_budget) result from its members' own results."""
    def pad(t, fill):
        return torch.cat([t, t.new_full((max_budget - t.shape[0],), fill)])

    return GreedyResult(
        order=torch.stack([pad(r.order, -1) for r in results]),
        gains=torch.stack([pad(r.gains, 0.0) for r in results]),
        n_evals=torch.stack([r.n_evals for r in results]),
        value=torch.stack([r.value for r in results]),
    )


# ---------------------------------------------------------------------------
# SieveStreaming
# ---------------------------------------------------------------------------

def _sieve_slots(max_budget: int, epsilon: float) -> int:
    """The JAX package's static ring size: one more than the widest possible
    live window [ceil(log_{1+eps} m), floor(log_{1+eps} 2km)]."""
    return int(math.floor(math.log(2.0 * max_budget) / math.log1p(epsilon))) + 2


def _sieve_window(m: np.ndarray, budget: int, epsilon: float):
    """Rung windows [lo, hi] of the running maxima ``m`` (fp32), as the JAX
    package computes them: fp32 log, and the division by log1p(eps) a
    multiplication by its fp32 reciprocal."""
    inv = recip32(math.log1p(epsilon))
    safe = torch.from_numpy(np.maximum(m, np.float32(1e-30)))
    lo = torch.ceil(log32(safe) * inv).to(torch.int64).numpy()
    hi = torch.floor(log32(safe * (2.0 * budget)) * inv).to(torch.int64).numpy()
    return lo, hi


@functools.lru_cache(maxsize=4096)
def _rung_value(rung: int, epsilon: float) -> np.float32:
    """v = exp(rung * log1p(eps)) in the JAX package's fp32."""
    x = torch.tensor([np.float32(rung) * np.float32(math.log1p(epsilon))], dtype=torch.float32)
    return np.float32(exp32(x)[0].item())


def _sieve_lifetimes(lo: np.ndarray, top: np.ndarray, has: np.ndarray, L: int):
    """(rung, first, end) for every sieve that is ever live: the maximal
    runs of arrivals during which the rung stays in the ring's window [lo,
    lo + L - 1] (leaving it resets the sieve), kept when the rung is live
    (has, and rung <= top) at some arrival of the run."""
    nv = lo.shape[0]
    if not has.any():
        return []
    starts = np.r_[0, np.flatnonzero(np.diff(lo)) + 1]
    ends = np.r_[starts[1:], nv]
    lo_k = lo[starts]
    rungs = np.arange(lo[has].min(), top[has].max() + 1)
    inside = (lo_k[None, :] <= rungs[:, None]) & (rungs[:, None] <= lo_k[None, :] + L - 1)
    out = []
    for r, row in zip(rungs.tolist(), inside):
        edges = np.flatnonzero(np.diff(np.r_[0, row.astype(np.int8), 0]))
        for k0, k1 in zip(edges[::2], edges[1::2]):
            a, b = int(starts[k0]), int(ends[k1 - 1])
            if (has[a:b] & (r <= top[a:b])).any():
                out.append((r, a, b))
    return out


class _Sieve:
    """One rung's sieve over one lifetime of arrivals."""

    def __init__(self, rung, first, end, v, kf, cstate):
        self.rung, self.cursor, self.end = rung, first, end
        self.v, self.kf = v, kf
        self.state = None  # None: the empty state
        self.order, self.gains = [], []
        self.value = np.float32(0.0)
        self.cstate = cstate
        self.window = _WINDOW_MIN

    def tau(self) -> np.float32:
        size = np.float32(len(self.order))
        return np.float32(
            (self.v * np.float32(0.5) - self.value) / np.maximum(self.kf - size, np.float32(1.0))
        )


def _sieve_one(fn, budget: int, valid, *, epsilon, seed, constraint, stop_zero, stop_neg):
    sweeper, state0, dev, ids, g0 = _stream_setup(fn, valid, seed)
    nv = ids.shape[0]
    L = _sieve_slots(budget, epsilon)
    m = np.maximum(np.maximum.accumulate(g0), np.float32(0.0)) if nv else g0
    lo, hi = _sieve_window(m, budget, epsilon)
    has = m > 0.0
    top = np.minimum(hi, lo + L - 1)  # the live rungs are [lo, top]
    # one singleton probe and one gain per live rung, per valid arrival
    n_evals = nv + int(np.where(has, np.maximum(top - lo + 1, 0), 0).sum())
    feas = HostFeasibility(constraint)
    kf = np.float32(budget)
    sieves = [
        _Sieve(r, a, b, _rung_value(r, epsilon), kf, feas.init())
        for r, a, b in _sieve_lifetimes(lo, top, has, L)
    ]
    active = [s for s in sieves if s.cursor < s.end]
    while active:
        windows = {}
        for s in active:
            # an empty sieve reads the singleton probes: its whole lifetime
            w = s.end - s.cursor if s.state is None else min(s.window, s.end - s.cursor)
            windows[s] = (s.cursor, s.cursor + w)
        swept = [s for s in active if s.state is not None]
        rows = sweeper.sweep(
            [s.state for s in swept], [ids[slice(*windows[s])] for s in swept]
        ) if swept else []
        gains = dict(zip(swept, rows))
        for s in active:
            a, b = windows[s]
            g = gains[s] if s in gains else g0[a:b]
            ok = (has[a:b] & (s.rung <= top[a:b]) & feas.ok(s.cstate, ids[a:b])
                  & _passes(g, stop_zero, stop_neg) & (g >= s.tau()))
            hit = np.flatnonzero(ok)
            if hit.size == 0:
                s.cursor, s.window = b, min(2 * s.window, _WINDOW_MAX)
                continue
            t = a + int(hit[0])
            gj = np.float32(g[hit[0]])
            j = int(ids[t])
            s.state = fn.update(state0 if s.state is None else s.state, _one_id(j, dev))
            s.order.append(j)
            s.gains.append(gj)
            s.value = np.float32(s.value + gj)
            s.cstate = feas.add(s.cstate, j)
            s.cursor, s.window = t + 1, _WINDOW_MIN
        active = [s for s in active if s.cursor < s.end and len(s.order) < budget]
    # the best sieve of the final live window, exact-value ties to the
    # lowest rung
    final = [s for s in sieves if nv and s.end == nv and has[-1] and s.rung <= top[-1]]
    if not final:
        return _result([], [], n_evals, np.float32(0.0), budget, dev)
    best = max(s.value for s in final)
    win = min((s for s in final if s.value == best), key=lambda s: s.rung)
    return _result(win.order, win.gains, n_evals, win.value, budget, dev)


def _sieve_batched(fns, max_budget, budgets, valid, stop_zero, stop_neg, *, epsilon, seed,
                   constraint):
    """A wave of sieves, member after member: each equals its sequential
    solve bit for bit (its own ladder, from its own budget)."""
    return _stack([
        _sieve_one(f, b, valid[i], epsilon=epsilon, seed=seed, constraint=constraint,
                   stop_zero=stop_zero, stop_neg=stop_neg)
        for i, (f, b) in enumerate(zip(fns, budgets.tolist()))
    ], max_budget)


def sieve_streaming(
    fn,
    budget: int,
    epsilon: float = 0.1,
    seed: int | None = None,
    constraint=None,
    stop_if_zero: bool = True,
    stop_if_negative: bool = True,
) -> GreedyResult:
    """One-pass sieve-streaming selection; (1/2 - eps)-approximate for
    monotone submodular ``fn``.  ``value`` is the winning sieve's running
    fp32 sum, as the JAX package reports it."""
    return _sieve_one(
        fn, int(budget), torch.ones((fn.n,), dtype=torch.bool),
        epsilon=_ladder_eps(epsilon), seed=seed, constraint=as_constraint(constraint),
        stop_zero=stop_if_zero, stop_neg=stop_if_negative,
    )


# ---------------------------------------------------------------------------
# ThresholdGreedy (buffered chunks, fixed descending ladder)
# ---------------------------------------------------------------------------

def _threshold_levels(n: int, epsilon: float) -> int:
    """Ladder length covering tau from d down to (eps/n) * d."""
    return int(
        math.ceil(math.log(max(n, 2) / epsilon) / -math.log1p(-epsilon))
    ) + 1


def _threshold_ladder(g0: np.ndarray, bs: int, epsilon: float):
    """Per chunk of ``bs`` arrivals: the (C, L) thresholds tau[c, l - 1] =
    d_c * exp((l - 1) * log1p(-eps)) for levels l = 1..L and whether each
    level is active (d_c > 0 and tau >= eps * d_c / n), with d_c the running
    max singleton gain after chunk c, in the JAX package's fp32."""
    nv = g0.shape[0]
    C = -(-nv // bs)
    L = _threshold_levels(nv, epsilon)
    padded = np.full(C * bs, -np.inf, np.float32)
    padded[:nv] = g0
    d = np.maximum(np.maximum.accumulate(padded.reshape(C, bs).max(axis=1)), np.float32(0.0))
    steps = torch.arange(L, dtype=torch.float32) * torch.tensor(
        np.float32(math.log1p(-epsilon)))
    decay = exp32(steps).numpy()
    tau = (d[:, None] * decay[None, :]).astype(np.float32)
    floor = (np.float32(epsilon) * d) / np.float32(max(nv, 1))
    active = (d[:, None] > 0.0) & (tau >= floor[:, None])
    return tau, active


def _threshold_visits(active, nv: int, bs: int, accepted: dict, last):
    """The ladder's visits: arrival q of chunk c is visited at every active
    level of its chunk up to the one that accepts it, and nothing is
    visited after the accept that fills the budget (``last``: its (c, l,
    p), or None)."""
    C, L = active.shape
    counts = np.concatenate([np.zeros((C, 1), np.int64), np.cumsum(active, axis=1)], axis=1)
    q = np.arange(nv)
    c, p = q // bs, q % bs
    lim = np.full(nv, L)
    for pos, lvl in accepted.items():
        lim[pos] = lvl
    if last is not None:
        lc, ll, lp = last
        cap = np.where(c < lc, L, np.where(c > lc, 0, np.where(p <= lp, ll, ll - 1)))
        lim = np.minimum(lim, cap)
    return int(counts[c, lim].sum())


def _threshold_one(fn, budget: int, valid, *, bs, epsilon, seed, constraint, stop_zero,
                   stop_neg):
    sweeper, state0, dev, ids, g0 = _stream_setup(fn, valid, seed)
    nv = ids.shape[0]
    if nv == 0:
        return _result([], [], 0, None, budget, dev)
    tau, active = _threshold_ladder(g0, bs, epsilon)
    C, L = tau.shape
    feas = HostFeasibility(constraint)
    cstate = feas.init()
    state, selected = None, np.zeros(nv, bool)
    order, gains, accepted, last = [], [], {}, None
    c0, l0, p0 = 0, 1, 0  # the next (chunk, level, position) event
    span = 1  # chunks per window
    lv = np.arange(1, L + 1)
    while len(order) < budget and c0 < C:
        c1 = min(C, c0 + span)
        a, b = c0 * bs, min(c1 * bs, nv)
        g = g0[a:b] if state is None else sweeper.sweep([state], [ids[a:b]])[0]
        q = np.arange(a, b)
        c, p = q // bs, q % bs
        lmin = np.where(c == c0, np.where(p >= p0, l0, l0 + 1), 1)
        # per arrival, the first level of its chunk at which it would be
        # accepted (the state, and so its gain, is fixed until an accept)
        fits = (active[c] & (g[:, None] >= tau[c]) & (lv[None, :] >= lmin[:, None]))
        eligible = (~selected[a:b] & feas.ok(cstate, ids[a:b])
                    & _passes(g, stop_zero, stop_neg) & fits.any(axis=1))
        if not eligible.any():
            c0, l0, p0, span = c1, 1, 0, min(2 * span, max(1, _CHUNK_WINDOW_MAX // bs))
            continue
        first_l = lv[np.argmax(fits, axis=1)]
        key = np.where(eligible, (c * (L + 1) + first_l) * bs + p, np.iinfo(np.int64).max)
        k = int(np.argmin(key))
        cq, lq, pq, t = int(c[k]), int(first_l[k]), int(p[k]), a + k
        j = int(ids[t])
        state = fn.update(state0 if state is None else state, _one_id(j, dev))
        selected[t] = True
        order.append(j)
        gains.append(np.float32(g[k]))
        accepted[t] = lq
        cstate = feas.add(cstate, j)
        c0, l0, p0, span = cq, lq, pq + 1, 1
        if len(order) == budget:
            last = (cq, lq, pq)
    n_evals = nv + _threshold_visits(active, nv, bs, accepted, last)
    return _result(order, gains, n_evals, None, budget, dev)


def _threshold_batched(fns, max_budget, budgets, valid, stop_zero, stop_neg, *, epsilon,
                       buffer_size, seed, constraint):
    """A wave of threshold ladders, member after member, each bit-equal to
    its sequential solve (its ladder from its own n)."""
    return _stack([
        _threshold_one(f, b, valid[i], bs=buffer_size, epsilon=epsilon, seed=seed,
                       constraint=constraint, stop_zero=stop_zero, stop_neg=stop_neg)
        for i, (f, b) in enumerate(zip(fns, budgets.tolist()))
    ], max_budget)


def threshold_greedy(
    fn,
    budget: int,
    epsilon: float = 0.1,
    buffer_size: int = 64,
    seed: int | None = None,
    constraint=None,
    stop_if_zero: bool = True,
    stop_if_negative: bool = True,
) -> GreedyResult:
    """Buffered threshold greedy over the arrival stream (fixed descending
    eps-ladder per chunk)."""
    return _threshold_one(
        fn, int(budget), torch.ones((fn.n,), dtype=torch.bool), bs=int(buffer_size),
        epsilon=_ladder_eps(epsilon), seed=seed, constraint=as_constraint(constraint),
        stop_zero=stop_if_zero, stop_neg=stop_if_negative,
    )


# ---------------------------------------------------------------------------
# Registry hooks
# ---------------------------------------------------------------------------

def _sieve_run(fn, budget, stop_zero, stop_neg, *, epsilon, seed, constraint):
    return sieve_streaming(fn, budget, epsilon, seed, constraint, stop_zero, stop_neg)


def _threshold_run(fn, budget, stop_zero, stop_neg, *, epsilon, buffer_size, seed, constraint):
    return threshold_greedy(
        fn, budget, epsilon, buffer_size, seed, constraint, stop_zero, stop_neg
    )


_STREAM_PARAMS = {
    "epsilon": Param(0.1, _ladder_eps, "threshold-ladder slack in (0, 1)"),
    "seed": Param(
        None, _opt_int_min(0), "arrival-order shuffle seed (None: index order)"
    ),
    "constraint": Param(
        None, as_constraint,
        "optional Knapsack / PartitionMatroid accept-rule constraint",
    ),
}

register_optimizer(
    "SieveStreaming",
    _sieve_run,
    params=dict(_STREAM_PARAMS),
    batched_run=_sieve_batched,
    mesh_replicated=True,
)
register_optimizer(
    "ThresholdGreedy",
    _threshold_run,
    params={
        **_STREAM_PARAMS,
        "buffer_size": Param(
            64, _int_min(1), "buffered chunk length for the ladder passes"
        ),
    },
    batched_run=_threshold_batched,
    mesh_replicated=True,
)
