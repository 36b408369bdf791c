"""The port's streaming optimizers (``repro_torch.core.optimizers.streaming``)
on the CPU, mirroring tests/test_streaming.py.

- SieveStreaming and ThresholdGreedy pick the JAX package's ids with its
  ``n_evals`` for every monotone servable family, with ``seed`` None and an
  int, with and without each constraint; gains and values within the
  family's bar (ROADMAP queue 3).
- The engine sweeps windows of arrivals at once; it equals a literal port
  of the JAX package's single-arrival loops (a one-element sweep per step,
  the ring of L slots) bit for bit: ids, gains, ``n_evals`` and value.
- That rests on index-local gathered sweeps: every family that declares
  ``local_gathers`` is checked here, and the families that do not (the FL
  measures, GraphCutMF, the combinators) take the one-arrival route, which
  equals the literal loop too.
- The ladders' fp32 ``exp`` / ``log`` are XLA's bit for bit.
- The (1/2 - eps) and (1 - 1/e - eps) guarantees, telescoped values, the
  constraints' accept rule, and served answers equal to sequential ones.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:
    from _propcheck import given, settings, st

from repro.core import Knapsack as JKnapsack
from repro.core import PartitionMatroid as JPartitionMatroid
from repro.core import SelectionSpec as JSelectionSpec
from repro.core import solve as jsolve
from repro_torch.core import (
    FLVMI,
    FeatureBased,
    GraphCutMF,
    Knapsack,
    PartitionMatroid,
    SelectionSpec,
    create_kernel,
    sieve_streaming,
    solve,
    threshold_greedy,
)
from repro_torch.core.optimizers import streaming as S
from repro_torch.core.optimizers._fp32 import exp32, log32, recip32
from repro_torch.core.optimizers.backends import partial_sweep
from repro_torch.core.optimizers.constrained import (
    HostFeasibility,
    as_constraint,
    streaming_add,
    streaming_feasible,
    streaming_state,
)
from repro_torch.launch.serve import SelectionServer

from _torch_serving_pairs import CPU, FAMILIES, near_ref, pair, port_fn, same

# every monotone family the server can coalesce, as in tests/test_streaming.py
MONOTONE_SERVABLE = ("fl", "fb", "sc", "psc", "gcmi", "flqmi")
STREAMING = ("SieveStreaming", "ThresholdGreedy")


def _opts(optimizer, **kw):
    return {"buffer_size": 6, **kw} if optimizer == "ThresholdGreedy" else kw


def _value(res) -> float:
    return float(np.asarray(res.gains).sum())


def _ids(res) -> list:
    return [int(j) for j in torch.as_tensor(res.order).tolist() if j >= 0]


# -- the ladders' arithmetic --------------------------------------------------


def test_fp32_exp_and_log_are_xlas():
    """exp32 / log32 equal jnp.exp / jnp.log under jit bit for bit, on random
    inputs (subnormal results flushed, as XLA flushes them) and on the
    rung grids of the ladders; x / c is x * recip32(c)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-90, 90, size=200_000).astype(np.float32)
    np.testing.assert_array_equal(
        exp32(torch.from_numpy(x)).numpy().view(np.int32),
        np.asarray(jax.jit(jnp.exp)(x)).view(np.int32))
    m = np.exp(rng.uniform(-80, 80, size=200_000)).astype(np.float32)
    m = m[np.isfinite(m) & (m > 0)]
    np.testing.assert_array_equal(
        log32(torch.from_numpy(m)).numpy().view(np.int32),
        np.asarray(jax.jit(jnp.log)(m)).view(np.int32))
    r = np.arange(-3000, 3000).astype(np.float32)
    for eps in (0.05, 0.1, 0.2):
        for c in (math.log1p(eps), math.log1p(-eps)):
            want = jax.jit(lambda r: jnp.exp(r * jnp.float32(c)))(r)
            got = exp32(torch.from_numpy(r) * torch.tensor(np.float32(c)))
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          np.asarray(want).view(np.int32))
        y = rng.uniform(-70, 70, 10_000).astype(np.float32)
        ls = math.log1p(eps)
        np.testing.assert_array_equal((torch.from_numpy(y) * recip32(ls)).numpy(),
                                      np.asarray(jax.jit(lambda y: y / ls)(y)))


# -- the gathered-sweep contract ----------------------------------------------

LOCAL = ("fl", "fl_kernel", "fb", "fb_kernel", "sc", "sc_kernel", "psc", "gcmi", "flqmi", "gc",
         "logdet", "dsum", "dmin", "flmf", "flmf_kernel", "flmf_dense", "flmf_knn")
# families that do not declare local gathers: the engine sweeps them one
# arrival at a time
ONE_AT_A_TIME = ("flvmi", "flcg", "flcmi", "gcmf", "gcmf_dense")


@pytest.mark.parametrize("kind", LOCAL)
def test_gathered_sweeps_are_index_local(kind):
    """A gathered sweep's value at an index does not depend on the indices
    swept with it, bit for bit, at a state holding three picks."""
    rng = np.random.default_rng(1)
    fn = port_fn(kind, rng, 300)
    assert S._Sweeper(fn, CPU).local, kind
    state = fn.init_state()
    for j in (5, 77, 201):
        state = fn.update(state, torch.tensor([j]))
    for k in (2, 7, 16, 33, 100, 300):
        idx = torch.from_numpy(rng.permutation(300)[:k])
        g = partial_sweep(fn, state, idx)
        single = torch.cat([partial_sweep(fn, state, idx[i : i + 1]) for i in range(k)])
        assert torch.equal(g.view(torch.int32), single.view(torch.int32)), (kind, k)


@pytest.mark.parametrize("kind", ONE_AT_A_TIME)
def test_families_without_local_gathers_sweep_one_arrival_at_a_time(kind):
    fn = port_fn(kind, np.random.default_rng(2), 20)
    assert not S._Sweeper(fn, CPU).local
    for optimizer in STREAMING:
        _same_as_literal(fn, 4, optimizer, 0.2, 3, None)


# -- literal ports of the JAX package's single-arrival loops (the oracle) ------


def _sweep1(fn, state, j):
    return np.float32(partial_sweep(fn, state, torch.tensor([j]))[0].item())


def _literal_sieve(fn, budget, eps, seed, constraint, stop_zero=True, stop_neg=True):
    n = fn.n
    L = S._sieve_slots(budget, eps)
    kf = np.float32(budget)
    feas = HostFeasibility(constraint)
    state0 = fn.init_state()
    arrival = S._arrival_order(torch.ones(n, dtype=torch.bool), seed).tolist()
    unset = -(2**31) + 1
    rungs, states = [unset] * L, [state0] * L
    sizes, values = [0] * L, [np.float32(0)] * L
    orders, gains, cst = [[] for _ in range(L)], [[] for _ in range(L)], [feas.init()] * L
    m, evals = np.float32(0), 0
    for t in range(n):
        j = arrival[t]
        m = max(m, _sweep1(fn, state0, j))
        lo, hi = (int(v[0]) for v in S._sieve_window(np.array([m], np.float32), budget, eps))
        n_live = 0
        for s in range(L):
            rung = lo + (s - lo) % L
            live = m > 0 and rung <= hi
            n_live += live
            if rung != rungs[s]:  # the slot's rung moved: a fresh sieve
                rungs[s], states[s], sizes[s], values[s] = rung, state0, 0, np.float32(0)
                orders[s], gains[s], cst[s] = [], [], feas.init()
            g = _sweep1(fn, states[s], j)
            v = S._rung_value(rung, eps)
            tau = np.float32((v * np.float32(0.5) - values[s])
                             / max(kf - np.float32(sizes[s]), np.float32(1)))
            ok = (live and sizes[s] < budget and feas.ok(cst[s], np.array([j]))[0]
                  and S._passes(np.array([g]), stop_zero, stop_neg)[0] and g >= tau)
            if ok:
                states[s] = fn.update(states[s], torch.tensor([j]))
                orders[s].append(j)
                gains[s].append(g)
                values[s] = np.float32(values[s] + g)
                sizes[s] += 1
                cst[s] = feas.add(cst[s], j)
        evals += 1 + n_live
    lo, hi = (int(v[0]) for v in S._sieve_window(np.array([m], np.float32), budget, eps))
    live = [s for s in range(L) if m > 0 and lo <= rungs[s] <= hi]
    if not live:
        return [], [], evals, np.float32(0)
    best = max(values[s] for s in live)
    s = min((s for s in live if values[s] == best), key=lambda s: rungs[s])
    return orders[s], gains[s], evals, values[s]


def _literal_threshold(fn, budget, eps, bs, seed, constraint, stop_zero=True, stop_neg=True):
    n = fn.n
    C, L = -(-n // bs), S._threshold_levels(n, eps)
    decay = exp32(torch.arange(L, dtype=torch.float32)
                  * torch.tensor(np.float32(math.log1p(-eps)))).numpy()
    feas = HostFeasibility(constraint)
    cst = feas.init()
    state0 = state = fn.init_state()
    arrival = S._arrival_order(torch.ones(n, dtype=torch.bool), seed).tolist()
    selected, order, gains = set(), [], []
    d, evals = np.float32(0), 0
    for c in range(C):
        for lvl in range(L + 1):
            for p in range(bs):
                pos = c * bs + p
                if pos >= n:
                    continue
                j = arrival[pos]
                if lvl == 0:
                    d = max(d, _sweep1(fn, state0, j))
                    evals += 1
                    continue
                tau = np.float32(d * decay[lvl - 1])
                active = d > 0 and tau >= (np.float32(eps) * d) / np.float32(n)
                if not (active and j not in selected and len(order) < budget):
                    continue
                evals += 1
                g = _sweep1(fn, state, j)
                if (feas.ok(cst, np.array([j]))[0] and S._passes(np.array([g]), stop_zero,
                                                                   stop_neg)[0] and g >= tau):
                    state = fn.update(state, torch.tensor([j]))
                    selected.add(j)
                    order.append(j)
                    gains.append(g)
                    cst = feas.add(cst, j)
    return order, gains, evals, None


def _same_as_literal(fn, budget, optimizer, eps, seed, constraint):
    what = f"{type(fn).__name__} {optimizer} eps={eps} seed={seed} {constraint}"
    if optimizer == "SieveStreaming":
        got = sieve_streaming(fn, budget, eps, seed, constraint)
        order, gains, evals, value = _literal_sieve(fn, budget, eps, seed, constraint)
    else:
        got = threshold_greedy(fn, budget, eps, 6, seed, constraint)
        order, gains, evals, value = _literal_threshold(fn, budget, eps, 6, seed, constraint)
    assert _ids(got) == order, what
    np.testing.assert_array_equal(got.gains.numpy()[: len(gains)].view(np.int32),
                                  np.asarray(gains, np.float32).view(np.int32), err_msg=what)
    assert int(got.n_evals) == evals, (what, int(got.n_evals), evals)
    if value is not None:
        assert np.float32(got.value.item()).view(np.int32) == value.view(np.int32), what


@pytest.mark.parametrize("optimizer", STREAMING)
@pytest.mark.parametrize("kind", ["fl", "fl_kernel", "fb", "sc", "psc", "gcmi", "flqmi", "flmf"])
def test_windowed_engine_equals_the_literal_loop(kind, optimizer):
    """Windows of arrivals per sweep, sieves by lifetime, empty sieves on
    the singleton probes: the literal loop's bits, with and without a seed
    and a constraint."""
    rng = np.random.default_rng(3)
    fn = port_fn(kind, rng, 30)
    labels = tuple(int(v) for v in rng.integers(0, 3, 30))
    costs = tuple(float(c) for c in rng.uniform(0.3, 1.2, 30))
    for eps, seed, cons in ((0.1, None, None), (0.2, 5, None),
                            (0.1, 2, PartitionMatroid(labels, (2, 1, 2))),
                            (0.2, None, Knapsack(costs, 2.0))):
        _same_as_literal(fn, 5, optimizer, eps, seed, cons)


# -- the JAX package's ids ----------------------------------------------------


@pytest.mark.parametrize("optimizer", STREAMING)
@pytest.mark.parametrize("kind", MONOTONE_SERVABLE)
def test_streaming_matches_jax(kind, optimizer):
    fn, jfn = pair(kind, np.random.default_rng(4), 28)
    for seed in (None, 7):
        kw = _opts(optimizer, epsilon=0.1, seed=seed)
        got = solve(SelectionSpec(fn, 5, optimizer, **kw))
        want = jsolve(JSelectionSpec(jfn, 5, optimizer, **kw))
        near_ref(got, want, FAMILIES[kind], f"{kind} {optimizer} seed {seed}")
        np.testing.assert_allclose(float(got.value), float(want.value), rtol=FAMILIES[kind],
                                   atol=FAMILIES[kind])


@pytest.mark.parametrize("optimizer", STREAMING)
@pytest.mark.parametrize("kind,seed", [("fl", None), ("fb", 3)])
def test_constrained_streaming_matches_jax(kind, seed, optimizer):
    rng = np.random.default_rng(5)
    fn, jfn = pair(kind, rng, 28)
    labels = tuple(int(v) for v in rng.integers(0, 3, 28))
    costs = tuple(float(c) for c in rng.uniform(0.3, 1.2, 28))
    for port_c, jax_c in ((Knapsack(costs, 2.0), JKnapsack(costs, 2.0)),
                          (PartitionMatroid(labels, (2, 1, 2)),
                           JPartitionMatroid(labels, (2, 1, 2)))):
        kw = _opts(optimizer, epsilon=0.2, seed=seed)
        got = solve(SelectionSpec(fn, 5, optimizer, constraint=port_c, **kw))
        want = jsolve(JSelectionSpec(jfn, 5, optimizer, constraint=jax_c, **kw))
        near_ref(got, want, FAMILIES[kind], f"{kind} {optimizer} {port_c}")


# -- guarantees, values, constraints ------------------------------------------


@pytest.mark.parametrize("family", MONOTONE_SERVABLE)
@settings(max_examples=2, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       budget=st.integers(min_value=2, max_value=5))
def test_sieve_half_minus_eps_guarantee(family, seed, budget):
    """f(sieve) >= (1/2 - eps) * greedy, greedy a lower bound on OPT."""
    fn = port_fn(family, np.random.default_rng(seed), 28)
    greedy = _value(solve(SelectionSpec(fn, budget)))
    for eps in (0.1, 0.2):
        sieve = solve(SelectionSpec(fn, budget, "SieveStreaming", epsilon=eps))
        assert _value(sieve) >= (0.5 - eps) * greedy - 1e-5, (family, eps)


@pytest.mark.parametrize("family", MONOTONE_SERVABLE)
@settings(max_examples=2, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       budget=st.integers(min_value=2, max_value=5))
def test_threshold_greedy_guarantee(family, seed, budget):
    """Multi-pass threshold greedy carries (1 - 1/e - eps) for monotone f."""
    fn = port_fn(family, np.random.default_rng(seed), 28)
    greedy = _value(solve(SelectionSpec(fn, budget)))
    tg = solve(SelectionSpec(fn, budget, "ThresholdGreedy", epsilon=0.1, buffer_size=8))
    assert _value(tg) >= (1.0 - 1.0 / np.e - 0.1) * greedy - 1e-5


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6))
def test_streaming_values_telescope(seed):
    fn = port_fn("fb", np.random.default_rng(seed), 24)
    for res in (sieve_streaming(fn, 4, epsilon=0.2),
                threshold_greedy(fn, 4, epsilon=0.2, buffer_size=6)):
        mask = torch.zeros(24, dtype=torch.bool)
        mask[_ids(res)] = True
        np.testing.assert_allclose(float(res.value), float(fn.evaluate(mask)), rtol=1e-5)
        np.testing.assert_allclose(_value(res), float(fn.evaluate(mask)), rtol=1e-5)


def test_constraint_validation():
    with pytest.raises(ValueError, match="positive"):
        Knapsack(costs=(1.0, -1.0), budget=2.0)
    with pytest.raises(ValueError, match="budget"):
        Knapsack(costs=(1.0,), budget=0.0)
    with pytest.raises(ValueError, match="index caps"):
        PartitionMatroid(labels=(0, 3), caps=(1, 1))
    with pytest.raises(TypeError, match="constraint must be"):
        as_constraint("knapsack")
    assert as_constraint(None) is None
    k = Knapsack(costs=[1, 2], budget=2.5)
    assert as_constraint(k) is k and hash(k) == hash(Knapsack((1.0, 2.0), 2.5))
    fn = port_fn("fl", np.random.default_rng(0), 10)
    with pytest.raises(TypeError, match="constraint"):
        SelectionSpec(fn, 3, "SieveStreaming", constraint="knapsack")
    with pytest.raises(TypeError, match="epsilon"):
        SelectionSpec(fn, 3, "ThresholdGreedy", epsilon=1.0)


def test_streaming_constraint_helpers_unit():
    k = Knapsack(costs=(1.0, 2.0, 3.0), budget=3.0)
    cs = streaming_state(k, width=2)
    assert cs.shape == (2,)
    assert streaming_feasible(k, cs, 2).tolist() == [True, True]  # cost 3 fits budget 3
    cs = streaming_add(k, cs, 2, torch.tensor([True, False]))
    assert cs.tolist() == [3.0, 0.0]
    assert streaming_feasible(k, cs, 0).tolist() == [False, True]  # selector 0 is full

    m = PartitionMatroid(labels=(0, 0, 1), caps=(1, 2))
    cm = streaming_state(m, width=2)
    assert cm.shape == (2, 2)
    cm = streaming_add(m, cm, 0, torch.tensor([True, True]))
    assert streaming_feasible(m, cm, 1).tolist() == [False, False]  # part 0 is at cap 1
    assert streaming_feasible(m, cm, 2).tolist() == [True, True]  # part 1 still open

    cs0 = streaming_state(None, width=3)
    assert bool(streaming_feasible(None, cs0, 0).all())
    assert streaming_add(None, cs0, 0, torch.tensor([True] * 3)) is cs0


@pytest.mark.parametrize("optimizer", STREAMING)
def test_streaming_constraints_hold(optimizer):
    rng = np.random.default_rng(6)
    fn = port_fn("fl", rng, 20)
    costs = tuple(float(c) for c in rng.uniform(0.5, 1.5, size=20))
    ids = _ids(solve(SelectionSpec(fn, 6, optimizer, epsilon=0.1,
                                   constraint=Knapsack(costs, 2.5))))
    assert ids and sum(costs[j] for j in ids) <= 2.5 + 1e-6
    labels = tuple(int(v) for v in rng.integers(0, 3, size=20))
    ids = _ids(solve(SelectionSpec(fn, 6, optimizer, epsilon=0.1,
                                   constraint=PartitionMatroid(labels, (2, 1, 2)))))
    counts = np.bincount([labels[j] for j in ids], minlength=3)
    assert ids and (counts <= np.array([2, 1, 2])).all()


# -- served, batched and padded waves equal sequential ------------------------


@pytest.mark.parametrize("optimizer", STREAMING)
def test_served_streaming_equals_sequential(optimizer):
    """Every monotone servable family at three sizes (padded into shared
    buckets where the family pads), with and without a seed and a
    constraint riding the OptimizerSpec: each served answer equals its
    sequential solve bit for bit."""
    rng = np.random.default_rng(7)
    cons = PartitionMatroid(tuple(v % 3 for v in range(40)), (2, 1, 2))
    specs = []
    for kind in MONOTONE_SERVABLE + ("fl_kernel", "fb_kernel", "flmf"):
        for n, budget in ((20, 3), (29, 5), (33, 4)):
            fn = port_fn(kind, rng, n)
            specs.append(SelectionSpec(fn, budget, optimizer, **_opts(optimizer, epsilon=0.1)))
            specs.append(SelectionSpec(fn, budget, optimizer,
                                       **_opts(optimizer, epsilon=0.2, seed=1, constraint=cons)))
    for spec, resp in zip(specs, SelectionServer().select(specs)):
        same(resp, solve(spec), repr(spec))


@pytest.mark.parametrize("optimizer", STREAMING)
def test_batched_streaming_wave_with_budgets_and_padding(optimizer):
    """solve(specs) with mixed budgets, and a zero-padded wave through
    BatchedEngine(valid=...): padded arrivals sort last and cost nothing."""
    from repro_torch.core import BatchedEngine, OptimizerSpec

    rng = np.random.default_rng(8)
    rows = [rng.uniform(0, 1, size=(24, 6)).astype(np.float32) for _ in range(3)]
    fns = [FeatureBased.from_features(r, device=CPU) for r in rows]
    kw = _opts(optimizer, epsilon=0.1, seed=4)
    specs = [SelectionSpec(f, b, optimizer, **kw) for f, b in zip(fns, (3, 6, 4))]
    for spec, got in zip(specs, solve(specs)):
        same(got, solve(spec))
    padded = [FeatureBased.from_features(np.vstack([r[:n], np.zeros((24 - n, 6), np.float32)]),
                                         device=CPU) for r, n in zip(rows, (24, 17, 20))]
    valid = np.zeros((3, 24), bool)
    for b, n in enumerate((24, 17, 20)):
        valid[b, :n] = True
    out = BatchedEngine(padded, valid=valid).run([3, 6, 4], OptimizerSpec(optimizer, **kw))
    for r, n, b, got in zip(rows, (24, 17, 20), (3, 6, 4), out):
        same(got, solve(SelectionSpec(FeatureBased.from_features(r[:n], device=CPU), b,
                                      optimizer, **kw)))


def test_streaming_empty_and_tiny_streams():
    """A stream whose gains are all zero selects nothing (the stop rules)
    and counts its probes; one arrival fills at most one slot."""
    fn = FeatureBased.from_features(np.zeros((6, 3), np.float32), device=CPU)
    for optimizer in STREAMING:
        res = solve(SelectionSpec(fn, 3, optimizer))
        assert _ids(res) == [] and int(res.n_evals) == 6
    one = FeatureBased.from_features(np.ones((1, 3), np.float32), device=CPU)
    for optimizer in STREAMING:
        assert _ids(solve(SelectionSpec(one, 2, optimizer))) == [0]


def test_streaming_on_graph_cut_mf_takes_the_one_arrival_route():
    """GraphCutMF's gathered sweeps are not declared local: it streams one
    arrival per sweep and still equals the literal loop."""
    x = np.random.default_rng(9).normal(size=(18, 4)).astype(np.float32)
    fn = GraphCutMF.from_features(x, lam=0.2, metric="cosine", device=CPU)
    assert not S._Sweeper(fn, CPU).local
    _same_as_literal(fn, 3, "SieveStreaming", 0.1, 2, None)


def test_flvmi_streams_through_the_one_arrival_route():
    x = np.random.default_rng(10).normal(size=(16, 5)).astype(np.float32)
    q = np.random.default_rng(11).normal(size=(3, 5)).astype(np.float32)
    fn = FLVMI.build(create_kernel(x, metric="euclidean", device=CPU),
                     create_kernel(x, q, metric="euclidean", device=CPU))
    _same_as_literal(fn, 3, "ThresholdGreedy", 0.2, None, None)
