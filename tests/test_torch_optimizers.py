"""The port's sampled, host-heap and constrained optimizers against the JAX
package on the CPU.

- The seeded draws (``repro_torch.core.optimizers._threefry``) equal
  ``jax.random``'s bit for bit: ``PRNGKey`` for every seed it accepts,
  ``fold_in`` keys, uniforms of any width, a block of steps at once, and
  the per-index scalar uniforms of the streaming arrival order.
- The sampled candidates come in ``jax.lax.top_k``'s order, ties to the
  lower index, and the LazierThanLazy screen orders bounds so too.
- StochasticGreedy and LazierThanLazyGreedy pick the JAX package's ids
  with its ``n_evals`` for the same seed, gains within the family's bar
  (ROADMAP queue 3), over FL, GC, FB, SC and LogDet, at seeds 0, 1, 12345
  and 2^31 - 1 and at an explicit sample size; so do the host heap greedy
  and the cover / knapsack / matroid greedies.
- The JAX package's quality and ordering tests in their port form
  (tests/test_optimizers.py, tests/test_greedy_properties.py), with small
  hypothesis budgets.
"""
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

from repro.core import PartitionMatroid as JPartitionMatroid
from repro.core import SelectionSpec as JSelectionSpec
from repro.core import cover_greedy as jcover_greedy
from repro.core import knapsack_greedy as jknapsack_greedy
from repro.core import matroid_greedy as jmatroid_greedy
from repro.core import solve as jsolve
from repro.core.optimizers.host_lazy import host_lazy_greedy as jhost_lazy_greedy
from repro_torch.core import (
    FacilityLocation,
    PartitionMatroid,
    SelectionSpec,
    SetCover,
    cover_greedy,
    create_kernel,
    host_lazy_greedy,
    knapsack_greedy,
    lazier_than_lazy_greedy,
    lazy_greedy,
    matroid_greedy,
    naive_greedy,
    solve,
    stochastic_greedy,
)
from repro_torch.core.optimizers import _threefry
from repro_torch.core.optimizers.greedy import _draw_keys, _sample_unselected
from repro_torch.launch.serve import SelectionServer

from _torch_serving_pairs import CPU, FAMILIES, near_ref, pair, port_fn

SEEDS = (0, 1, 12345, 2**31 - 1)
# PRNGKey takes any seed below 2**63 and keeps its low 32 bits
KEY_SEEDS = SEEDS + (2**31, 2**32, 2**33 + 5, 2**63 - 1)


def _key(jkey) -> tuple:
    return tuple(int(v) for v in np.asarray(jkey))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# -- the draws ----------------------------------------------------------------


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    key, jkey = _threefry.prng_key(seed), jax.random.PRNGKey(seed)
    assert key == _key(jkey)
    for i in (0, 1, 7, 4999, 2**31 - 1):
        assert _threefry.fold_in(key, i) == _key(jax.random.fold_in(jkey, i))
    steps = torch.tensor([0, 3, 4999], dtype=torch.int64)
    k0, k1 = _threefry.fold_in(key, steps)
    for s, a, b in zip(steps.tolist(), k0.tolist(), k1.tolist()):
        assert (a, b) == _key(jax.random.fold_in(jkey, s))


def test_prng_key_refuses_what_jax_refuses():
    for seed in (2**63, 2**64 - 1):
        with pytest.raises(OverflowError):
            jax.random.PRNGKey(seed)
        with pytest.raises(OverflowError):
            _threefry.prng_key(seed)


@pytest.mark.parametrize("n", [1, 7, 1000, 50000])
def test_uniform_draws_match_jax(n):
    for seed in (0, 2**31 - 1):
        key = _threefry.fold_in(_threefry.prng_key(seed), 3)
        want = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), 3), (n,))
        np.testing.assert_array_equal(_bits(_threefry.uniform(key, n, CPU)), _bits(want))


def test_step_blocks_and_arrival_uniforms_match_jax():
    key, jkey = _threefry.prng_key(12345), jax.random.PRNGKey(12345)
    block = _threefry.step_bits(key, range(5, 9), 1000, CPU)
    for row, i in zip(block, range(5, 9)):
        want = jax.random.uniform(jax.random.fold_in(jkey, i), (1000,))
        np.testing.assert_array_equal(_bits(_threefry.bits_to_uniform(row)), _bits(want))
    want = jax.vmap(lambda j: jax.random.uniform(jax.random.fold_in(jkey, j)))(jnp.arange(300))
    np.testing.assert_array_equal(_bits(_threefry.fold_in_uniforms(key, 300, CPU)), _bits(want))


# -- top_k order --------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 5, 40, 64])
def test_sample_order_matches_lax_top_k_with_ties(size):
    """Few distinct uniforms (many ties) and a selected mask: the sample is
    jax.lax.top_k's, ties to the lower index, selected entries last (size
    64 reaches into them)."""
    rng = np.random.default_rng(size)
    mant = rng.integers(0, 4, size=64).astype(np.int64)
    selected = rng.random(64) < 0.3
    u = (mant.astype(np.int32) | np.int32(0x3F800000)).view(np.float32) - np.float32(1.0)
    want = jax.lax.top_k(jnp.where(jnp.asarray(selected), -1.0, jnp.asarray(u)), size)[1]
    rev = 0xFFFFFFFF - torch.arange(64, dtype=torch.int64)
    keys = _draw_keys(torch.from_numpy(mant), rev)
    got = _sample_unselected(keys, torch.from_numpy(selected), rev, size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_screen_order_matches_lax_top_k_with_ties():
    """LazierThanLazyGreedy's screen: a stable descending sort, as top_k
    orders equal bounds (NEG_INF ones included)."""
    rng = np.random.default_rng(3)
    for k in (1, 3, 8, 20):
        vals = rng.choice(np.float32([-1e30, 0.25, 0.5, 0.5, 1.0]), size=20)
        want = jax.lax.top_k(jnp.asarray(vals), k)[1]
        got = torch.sort(torch.from_numpy(vals), descending=True, stable=True).indices[:k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the sampled greedies against the JAX package -----------------------------

SAMPLED = [
    ("StochasticGreedy", {}),
    ("StochasticGreedy", {"sample_size": 7}),
    ("LazierThanLazyGreedy", {}),
    ("LazierThanLazyGreedy", {"sample_size": 7, "screen_k": 3}),
]


@pytest.mark.parametrize("kind", ["fl", "gc", "fb", "sc", "logdet"])
@pytest.mark.parametrize("optimizer,opts", SAMPLED, ids=["sg", "sg_s7", "ltl", "ltl_s7"])
def test_sampled_greedies_match_jax(kind, optimizer, opts):
    fn, jfn = pair(kind, np.random.default_rng(5), 60)
    for seed in SEEDS:
        got = solve(SelectionSpec(fn, 8, optimizer, seed=seed, **opts))
        want = jsolve(JSelectionSpec(jfn, 8, optimizer, seed=seed, **opts))
        near_ref(got, want, FAMILIES[kind], f"{kind} {optimizer} {opts} seed {seed}")


def test_sampled_greedies_take_the_seeds_prngkey_takes():
    fn, jfn = pair("fl", np.random.default_rng(6), 30)
    for seed in (2**31, 2**63 - 1):
        near_ref(solve(SelectionSpec(fn, 4, "StochasticGreedy", seed=seed)),
                 jsolve(JSelectionSpec(jfn, 4, "StochasticGreedy", seed=seed)), 1e-5)
    for spec_cls, f, run in ((SelectionSpec, fn, solve), (JSelectionSpec, jfn, jsolve)):
        with pytest.raises(TypeError, match="seed"):
            spec_cls(f, 4, "StochasticGreedy", seed=-1)
        with pytest.raises(OverflowError):
            run(spec_cls(f, 4, "LazierThanLazyGreedy", seed=2**63))


def test_sampled_greedies_ride_no_waves():
    """No wave hooks, as in the JAX package: the batched route and the
    server refuse them, the sequential route runs them."""
    fn, _ = pair("fl", np.random.default_rng(7), 20)
    spec = SelectionSpec(fn, 3, "StochasticGreedy")
    with pytest.raises(ValueError, match="batched-capable"):
        solve([spec, spec], mode="batched")
    with pytest.raises(ValueError, match="batched-capable"):
        SelectionServer().submit_spec(spec)
    assert len(solve(spec).as_list()) == 3


# -- host heap and constrained greedies against the JAX package ---------------


@pytest.mark.parametrize("kind", ["fl", "gc", "fb", "sc", "logdet"])
def test_host_lazy_matches_jax(kind):
    fn, jfn = pair(kind, np.random.default_rng(8), 40)
    order, gains, n_evals = host_lazy_greedy(fn, 8)
    jorder, jgains, jn_evals = jhost_lazy_greedy(jfn, 8)
    assert order == jorder and n_evals == jn_evals
    np.testing.assert_allclose(gains, jgains, rtol=FAMILIES[kind], atol=FAMILIES[kind])


def _literal_host_lazy(fn, budget):
    """The JAX package's heap loop as written: one sweep of one candidate
    per stale pop."""
    import heapq

    from repro_torch.core.optimizers.backends import full_sweep, partial_sweep

    state = fn.init_state()
    ub = full_sweep(fn, state).numpy().astype(np.float64)
    n_evals = len(ub)
    heap = [(-ub[i], i, 0) for i in range(len(ub))]
    heapq.heapify(heap)
    order, gains = [], []
    while len(order) < budget and heap:
        neg_ub, j, fresh_at = heapq.heappop(heap)
        if fresh_at == len(order):
            g = -neg_ub
        else:
            g = float(partial_sweep(fn, state, torch.tensor([j]))[0])
            n_evals += 1
            if heap and -heap[0][0] > g + 1e-12:
                heapq.heappush(heap, (-g, j, len(order)))
                continue
        if g <= 0.0:
            break
        state = fn.update(state, torch.tensor([j]))
        order.append(j)
        gains.append(g)
    return order, gains, n_evals


@pytest.mark.parametrize("kind", ["fl", "fl_kernel", "fb", "flvmi"])
def test_host_lazy_equals_the_one_pop_one_sweep_loop(kind):
    """Evaluating the next stale pops ahead in one gathered sweep changes no
    pop: ids, gains and n_evals equal the literal loop's (FLVMI, whose
    gathers are not declared local, evaluates one pop at a time)."""
    fn = port_fn(kind, np.random.default_rng(10), 150)
    assert host_lazy_greedy(fn, 20) == _literal_host_lazy(fn, 20)


@pytest.mark.parametrize("kind", ["fl", "fb", "sc"])
def test_constrained_greedies_match_jax(kind):
    rng = np.random.default_rng(9)
    fn, jfn = pair(kind, rng, 40)
    tol = FAMILIES[kind]
    costs = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    total = float(fn.evaluate(torch.ones(40, dtype=torch.bool)))
    labels = tuple(int(v) for v in rng.integers(0, 3, 40))
    cases = [
        (cover_greedy(fn, 0.6 * total, 12, costs),
         jcover_greedy(jfn, jnp.asarray(0.6 * total), 12, costs)),
        (cover_greedy(fn, 0.5 * total, 12),
         jcover_greedy(jfn, jnp.asarray(0.5 * total), 12)),
        (knapsack_greedy(fn, 4.0, 12, costs), jknapsack_greedy(jfn, jnp.asarray(4.0), 12, costs)),
        (matroid_greedy(fn, PartitionMatroid(labels, (2, 1, 2)), 8),
         jmatroid_greedy(jfn, JPartitionMatroid(labels, (2, 1, 2)), 8)),
    ]
    for i, (got, want) in enumerate(cases):
        near_ref(got, want, tol, f"{kind} case {i}")
        np.testing.assert_allclose(float(got.value), float(want.value), rtol=tol, atol=tol)


# -- quality and ordering: tests/test_optimizers.py:98-121 --------------------


def _clustered_fl(rng, n):
    centers = rng.normal(scale=4.0, size=(6, 5))
    x = (centers[rng.integers(0, 6, n)] + rng.normal(scale=0.7, size=(n, 5))).astype(np.float32)
    return FacilityLocation.from_kernel(create_kernel(x, metric="euclidean", device=CPU))


def test_stochastic_and_ltl_quality():
    fn = _clustered_fl(np.random.default_rng(0), 60)
    ref = float(naive_greedy(fn, 10).value)
    key = _threefry.prng_key(0)
    assert float(stochastic_greedy(fn, 10, key, 0.01).value) >= 0.95 * ref
    assert float(lazier_than_lazy_greedy(fn, 10, key, 0.01).value) >= 0.95 * ref


def test_eval_count_ordering():
    """The paper's Table 2 ordering: evaluations(naive) > evaluations(
    stochastic) and > evaluations(lazy); LazierThanLazy adds one full sweep."""
    fn = _clustered_fl(np.random.default_rng(0), 60)
    key = _threefry.prng_key(0)
    ev_naive = int(naive_greedy(fn, 10).n_evals)
    ev_st = int(stochastic_greedy(fn, 10, key, 0.01).n_evals)
    ev_lazy = int(lazy_greedy(fn, 10).n_evals)
    ev_ltl = int(lazier_than_lazy_greedy(fn, 10, key, 0.01).n_evals)
    assert ev_naive > ev_st and ev_naive > ev_lazy
    assert ev_ltl <= ev_st + 60


def test_host_lazy_equals_naive():
    fn = _clustered_fl(np.random.default_rng(1), 40)
    r_naive = naive_greedy(fn, 8)
    order, gains, n_evals = host_lazy_greedy(fn, 8)
    mask = torch.zeros(40, dtype=torch.bool)
    mask[order] = True
    np.testing.assert_allclose(float(fn.evaluate(mask)), float(r_naive.value), rtol=1e-4,
                               atol=1e-4)
    assert n_evals <= int(r_naive.n_evals)


# -- properties: tests/test_greedy_properties.py:61-95 ------------------------


def _fl(rng, n=24):
    x = rng.normal(size=(n, 5)).astype(np.float32)
    return FacilityLocation.from_kernel(create_kernel(x, metric="euclidean", device=CPU))


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_stochastic_quality_over_seeds(seed):
    fn = _fl(np.random.default_rng(0), n=48)
    ref = float(naive_greedy(fn, 8).value)
    got = float(stochastic_greedy(fn, 8, _threefry.prng_key(seed), 0.05).value)
    assert got >= 0.85 * ref  # per-seed floor (expectation is 1-1/e-eps)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), budget=st.floats(1.0, 6.0))
def test_knapsack_feasibility(seed, budget):
    rng = np.random.default_rng(seed)
    fn = _fl(rng)
    costs = rng.uniform(0.3, 2.0, fn.n).astype(np.float32)
    chosen = [i for i, _ in knapsack_greedy(fn, budget, fn.n, costs).as_list()]
    assert sum(costs[i] for i in chosen) <= budget + 1e-5
    assert len(set(chosen)) == len(chosen)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), frac=st.floats(0.2, 0.9))
def test_cover_reaches_requested_coverage(seed, frac):
    rng = np.random.default_rng(seed)
    cover = rng.integers(0, 2, size=(20, 14)).astype(np.float32)
    cover[0] = 1.0  # every concept coverable
    fn = SetCover.from_cover(cover, device=CPU)
    total = float(fn.evaluate(torch.ones(20, dtype=torch.bool)))
    assert float(cover_greedy(fn, frac * total, 20).value) >= frac * total - 1e-5
