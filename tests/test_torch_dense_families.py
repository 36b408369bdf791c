"""The port's dense pairwise families against the JAX package on the CPU: the
gc / dsum / dmin kernels' plain versions against the JAX Pallas kernels
(interpret mode) and oracles, gc / dsum's against a model of their
kernels' summation order written out here, gc_gains_at against gc_gains
bit for bit,
GraphCut and DisparitySum / DisparityMin / DisparityMinSum selections,
evaluate, the gain identity, the family stop defaults and the state
hand-over.

Inputs are numpy arrays from a seed, handed to both packages.  Bars: the
JAX package's own (tests/test_kernels.py:143-212, 352-431): 1e-4 for the
graph-cut sweep, 1e-5 for DisparitySum's and DisparityMinSum's sums (fp32
sums in another order than XLA's), and bit equality for DisparityMin,
whose masked min does not depend on order.  Ids and n_evals must be equal.
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_gpu.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.kernels import ops as jops
from repro_torch.common import NEG_INF
from repro_torch.core import (
    DisparityMin,
    DisparityMinSum,
    DisparitySum,
    GraphCutMF,
    SelectionSpec,
    backend_name,
    family_defaults,
    solve,
)
from repro_torch.core.optimizers.backends import full_sweep
from repro_torch.interop import (
    disparity_min_from_arrays,
    disparity_min_sum_from_arrays,
    disparity_sum_from_arrays,
    dmin_state_from_arrays,
    dmin_sum_state_from_arrays,
    dsum_state_from_arrays,
    gc_state_from_arrays,
    graph_cut_from_arrays,
    result_to_numpy,
    state_to_arrays,
)
from repro_torch.kernels import ops
from repro_torch.kernels.disp_gains import BIG, dmin_finish, dmin_gains_plain
from repro_torch.kernels.gc_gains import gc_gains_plain
from repro_torch.kernels.select_cols import select_cols

GC_TOL = dict(rtol=1e-4, atol=1e-4)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [8, 100, 128, 257]
OPTIMIZERS = [("NaiveGreedy", {}), ("LazyGreedy", {"screen_k": 8})]
N, D, BUDGET = 60, 8, 10
_JAX: dict = {}


def _t(a):
    return torch.from_numpy(np.array(a))


def _sim(n, rng):
    s = rng.uniform(0, 1, size=(n, n)).astype(np.float32)
    return (s + s.T) / 2


def _dist(n, rng, lo=0.1):
    d = rng.uniform(lo, 2, size=(n, n)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return d


# -- the kernels' plain versions vs the Pallas kernels and the oracles --------


@pytest.mark.parametrize("n", SHAPES)
def test_gc_plain_matches_jax_kernel_and_oracle(n):
    rng = np.random.default_rng(n)
    s = _sim(n, rng)
    m = (rng.uniform(size=n) < 0.3).astype(np.float32)
    tot = s.sum(axis=0).astype(np.float32)
    got = ops.gc_gains(_t(s), _t(m), _t(tot), torch.tensor(0.4)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.gc_gains(s, m, tot, 0.4)), **GC_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.gc_gains_ref(s, m, tot, 0.4)), **GC_TOL)


SUBSET_IDX = [
    np.array([0, 5, 47, 12], np.int32),  # plain gather
    np.array([3, 3, 3, 40, 40], np.int32),  # duplicates
    np.array([7, -1, 20, -1, -1], np.int32),  # padding slots
    np.array([47, 60, 99, 0], np.int32),  # idx >= n reads row n - 1
    np.arange(48, dtype=np.int32)[::-1].copy(),  # every row, reversed
]


@pytest.mark.parametrize("idx", SUBSET_IDX, ids=["gather", "dups", "pads", "clipped", "all"])
def test_gc_at_plain_matches_jax_and_equals_full_bit_for_bit(idx):
    """The JAX package's contract (tests/test_kernels.py:486-500): the
    gathered sweep equals the full sweep bit for bit at the same index."""
    rng = np.random.default_rng(11)
    n = 48
    sim = _sim(n, rng)
    total = sim.sum(axis=0).astype(np.float32)
    selmask = (rng.uniform(size=n) < 0.3).astype(np.float32)
    lam = torch.tensor(0.4)
    got = ops.gc_gains_at(_t(sim), _t(selmask), _t(total), lam, _t(idx))
    full = gc_gains_plain(_t(sim), _t(selmask), _t(total), lam)
    keep = idx >= 0
    assert torch.equal(got[keep], full[np.minimum(idx[keep], n - 1)])
    assert bool((got[~keep] == NEG_INF).all())
    jlam = jnp.float32(0.4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.gc_gains_at(sim, selmask, total, jlam, idx)), **GC_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.gc_gains_at_ref(sim, selmask, total, jlam, idx)), **GC_TOL)


@pytest.mark.parametrize("n", SHAPES)
def test_dsum_plain_matches_jax_kernel_and_oracle(n):
    rng = np.random.default_rng(n + 1)
    d = _dist(n, rng, lo=0.0)
    m = (rng.uniform(size=n) < 0.3).astype(np.float32)
    got = ops.dsum_gains(_t(d), _t(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.dsum_gains(d, m)), **SUM_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.dsum_gains_ref(d, m)), **SUM_TOL)


# gc / dsum selections: |A| = 0, 1, a warp's 32 lanes and one either side,
# n/8, every item and a random 30% of the items (|A| capped at n)
SUM_SELECTIONS = ["0", "1", "31", "32", "33", "n/8", "n", "random"]


def _sum_mask(n, which, rng):
    if which == "random":
        return (rng.uniform(size=n) < 0.3).astype(np.float32)
    k = min(n, {"0": 0, "1": 1, "31": 31, "32": 32, "33": 33, "n/8": n // 8, "n": n}[which])
    m = np.zeros(n, np.float32)
    m[rng.permutation(n)[:k]] = 1.0
    return m


def _warp_model(mat, m):
    """The gc / dsum kernels' order, written out in numpy fp32: the columns
    c with m_c != 0 in ascending order, term t (mat[:, c] * m_c) added by lane
    t % 32 in increasing t, then the halving tree, lane i taking lane i + h
    for h = 16 .. 1."""
    lanes = np.zeros((mat.shape[0], 32), np.float32)
    for t, c in enumerate(np.flatnonzero(m != 0)):
        lanes[:, t % 32] = lanes[:, t % 32] + mat[:, c] * m[c]
    h = 16
    while h:
        lanes[:, :h] = lanes[:, :h] + lanes[:, h : 2 * h]
        h //= 2
    return lanes[:, 0]


def _gc_model(s, m, tot, lam):
    """gc_gains in the kernel's steps: the selected-columns sum of S * 2m,
    then the diagonal, then total - lam * (...)."""
    return tot - np.float32(lam) * (_warp_model(s, (2 * m).astype(np.float32)) + np.diagonal(s))


@pytest.mark.parametrize("which", SUM_SELECTIONS)
@pytest.mark.parametrize("n", SHAPES)
def test_dsum_plain_is_the_compacted_warp_order(n, which):
    """dsum_gains_plain sums the selected columns in the kernel's order, bit
    for bit, and matches the JAX kernel and oracle within SUM_TOL."""
    rng = np.random.default_rng(n + 3)
    d = _dist(n, rng, lo=0.0)
    m = _sum_mask(n, which, rng)
    got = ops.dsum_gains(_t(d), _t(m)).numpy()
    np.testing.assert_array_equal(got, _warp_model(d, m))
    np.testing.assert_allclose(got, np.asarray(jops.dsum_gains(d, m)), **SUM_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.dsum_gains_ref(d, m)), **SUM_TOL)


@pytest.mark.parametrize("which", SUM_SELECTIONS)
@pytest.mark.parametrize("n", SHAPES)
def test_gc_plain_is_the_compacted_warp_order(n, which):
    """gc_gains_plain sums the selected columns in the kernel's order, then
    adds the diagonal, bit for bit; it matches the JAX kernel and oracle
    within GC_TOL; gc_gains_at_plain equals it at indices in A and not in A."""
    rng = np.random.default_rng(n + 4)
    s = _sim(n, rng)
    m = _sum_mask(n, which, rng)
    tot = s.sum(axis=0).astype(np.float32)
    lam = torch.tensor(0.4)
    got = ops.gc_gains(_t(s), _t(m), _t(tot), lam)
    np.testing.assert_array_equal(got.numpy(), _gc_model(s, m, tot, 0.4))
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.gc_gains(s, m, tot, 0.4)), **GC_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.gc_gains_ref(s, m, tot, 0.4)), **GC_TOL)
    idx = np.concatenate([np.flatnonzero(m)[:3], np.flatnonzero(m == 0)[:3], [-1]]).astype(np.int32)
    at = ops.gc_gains_at(_t(s), _t(m), _t(tot), lam, _t(idx))
    assert torch.equal(at[:-1], got[idx[:-1]])
    assert bool(at[-1] == NEG_INF)


@pytest.mark.parametrize("family", ["dsum", "gc"])
def test_sums_take_a_non_binary_mask_as_the_jax_kernel_does(family):
    """Mask values other than 0 / 1 (negative, fractional, > 1) weigh their
    columns as the JAX kernel's m_k does; a -0.0 selects nothing."""
    n = 100
    rng = np.random.default_rng(13)
    m = np.where(rng.uniform(size=n) < 0.4, rng.choice([-1.5, 0.25, 2.0, 3.75], size=n), 0.0)
    m = m.astype(np.float32)
    m[:3] = -0.0
    if family == "dsum":
        d = _dist(n, rng, lo=0.0)
        got = ops.dsum_gains(_t(d), _t(m)).numpy()
        np.testing.assert_array_equal(got, _warp_model(d, m))
        np.testing.assert_allclose(got, np.asarray(jops.dsum_gains(d, m)), **SUM_TOL)
        np.testing.assert_allclose(got, np.asarray(jops.dsum_gains_ref(d, m)), **SUM_TOL)
    else:
        s = _sim(n, rng)
        tot = s.sum(axis=0).astype(np.float32)
        got = ops.gc_gains(_t(s), _t(m), _t(tot), torch.tensor(0.4)).numpy()
        np.testing.assert_array_equal(got, _gc_model(s, m, tot, 0.4))
        np.testing.assert_allclose(got, np.asarray(jops.gc_gains(s, m, tot, 0.4)), **GC_TOL)
        np.testing.assert_allclose(got, np.asarray(jops.gc_gains_ref(s, m, tot, 0.4)), **GC_TOL)


# DisparityMin selections: |A| = 0, 1, the CUDA kernel's gather / stream
# crossover at 8 |A| = n (n/8 - 1 gathers, n/8 and n/8 + 1 stream), every
# item, and a random 30% of the items
DMIN_SELECTIONS = ["0", "1", "n/8-1", "n/8", "n/8+1", "n", "random"]


def _dmin_inputs(n, which):
    rng = np.random.default_rng(n + 2)
    d = _dist(n, rng)
    if which == "random":
        m = (rng.uniform(size=n) < 0.3).astype(np.float32)
    else:
        k = {"0": 0, "1": 1, "n/8-1": n // 8 - 1, "n/8": n // 8, "n/8+1": n // 8 + 1, "n": n}[which]
        m = np.zeros(n, np.float32)
        m[rng.permutation(n)[:k]] = 1.0
    count = int(m.sum())
    curmin = float(rng.uniform(0, 1)) if count else 0.0
    return d, m, count, curmin


@pytest.mark.parametrize("which", DMIN_SELECTIONS)
@pytest.mark.parametrize("n", SHAPES)
def test_dmin_plain_equals_jax_kernel_and_oracle_bit_for_bit(n, which):
    d, m, count, curmin = _dmin_inputs(n, which)
    got = ops.dmin_gains(_t(d), _t(m), torch.tensor(count, dtype=torch.int32),
                         torch.tensor(curmin)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.dmin_gains(d, m, count, curmin)))
    np.testing.assert_array_equal(got, np.asarray(jops.dmin_gains_ref(d, m, count, curmin)))


@pytest.mark.parametrize("which", DMIN_SELECTIONS)
@pytest.mark.parametrize("n", SHAPES)
def test_dmin_gather_form_equals_plain_bit_for_bit(n, which):
    """The plain model of the CUDA kernel's gather branch: the min over the
    compacted selected columns alone (BIG for none), then the finish, equals
    the masked min over every column bit for bit (a min has no order)."""
    d, m, count, curmin = _dmin_inputs(n, which)
    dist, mask = _t(d), _t(m)
    count, curmin = torch.tensor(count, dtype=torch.int32), torch.tensor(curmin)
    sel, k = select_cols(mask, "positive")
    sel = sel[: int(k)].long()
    assert torch.equal(sel, torch.nonzero(mask > 0).flatten())
    mind = dist.index_select(1, sel).amin(1) if sel.numel() else torch.full((n,), BIG)
    assert torch.equal(dmin_finish(mind, count, curmin),
                       dmin_gains_plain(dist, mask, count, curmin))


def test_dmin_empty_selection_is_zero():
    """|A| = 0: the surrogate collapses to 0 - f({}) = 0 for every candidate
    (tests/test_kernels.py:387)."""
    d = np.random.default_rng(5).uniform(0, 2, size=(40, 40)).astype(np.float32)
    got = ops.dmin_gains(_t(d), torch.zeros(40), torch.zeros((), dtype=torch.int32),
                         torch.zeros(()))
    assert torch.equal(got, torch.zeros(40))


def test_dense_wrappers_check_their_inputs():
    s, v = torch.rand((8, 8)), torch.rand(8)
    lam, cnt = torch.tensor(0.4), torch.tensor(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="square"):
        ops.gc_gains(torch.rand((8, 7)), v, v, lam)
    with pytest.raises(TypeError, match="float32"):
        ops.dsum_gains(s.double(), v)
    with pytest.raises(ValueError, match="does not match"):
        ops.dsum_gains(s, torch.rand(7))
    with pytest.raises(ValueError, match="contiguous"):
        ops.dmin_gains(s.T, v, cnt, lam)
    with pytest.raises(TypeError, match="lam"):
        ops.gc_gains(s, v, v, 0.4)
    with pytest.raises(TypeError, match="count"):
        ops.dmin_gains(s, v, cnt.float(), lam)
    with pytest.raises(TypeError, match="idx"):
        ops.gc_gains_at(s, v, v, lam, torch.tensor([0.0]))


# -- selection against the JAX package ----------------------------------------


def _features(seed=0):
    return np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)


def _gc_sim():
    return np.asarray(J.create_kernel(_features(), metric="cosine"))


def _distances():
    """The JAX package's diversity distances (src/repro/data/selection.py:67-70)."""
    sim = J.create_kernel(_features(1), metric="euclidean")
    return np.asarray(1.0 / jnp.maximum(sim, 1e-6) - 1.0)


def _jax_fn(family, use_kernel=False, lam=0.3):
    key = (family, use_kernel, lam)
    if key not in _JAX:
        if family == "gc":
            _JAX[key] = J.GraphCut.from_kernel(jnp.asarray(_gc_sim()), lam=lam, use_kernel=use_kernel)
        elif family == "dminsum":
            _JAX[key] = J.DisparityMinSum.from_distance(jnp.asarray(_distances()))
        else:
            cls = {"dsum": J.DisparitySum, "dmin": J.DisparityMin}[family]
            _JAX[key] = cls.from_distance(jnp.asarray(_distances()), use_kernel=use_kernel)
    return _JAX[key]


def _port_fn(family, use_kernel=False, lam=0.3):
    jfn = _jax_fn(family, use_kernel, lam)
    if family == "gc":
        return graph_cut_from_arrays(np.asarray(jfn.sim_ground), np.asarray(jfn.total),
                                     np.asarray(jfn.lam), use_kernel, device="cpu")
    dist = np.asarray(jfn.dist)
    if family == "dminsum":
        return disparity_min_sum_from_arrays(dist, device="cpu")
    make = {"dsum": disparity_sum_from_arrays, "dmin": disparity_min_from_arrays}[family]
    return make(dist, use_kernel, device="cpu")


def _jax_result(family, optimizer, params, use_kernel=False, lam=0.3):
    key = ("res", family, optimizer, use_kernel, lam)
    if key not in _JAX:
        res = J.solve(J.SelectionSpec(_jax_fn(family, use_kernel, lam), BUDGET, optimizer, **params))
        _JAX[key] = (np.asarray(res.order), np.asarray(res.gains), int(res.n_evals))
    return _JAX[key]


def _assert_same(port, jax_res, tol):
    order, gains, n_evals, _ = result_to_numpy(port)
    np.testing.assert_array_equal(order, jax_res[0])
    assert n_evals == jax_res[2]
    if tol is None:
        np.testing.assert_array_equal(gains, jax_res[1])
    else:
        np.testing.assert_allclose(gains, jax_res[1], **tol)


@pytest.mark.parametrize("lam", [0.3, 0.7])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_graph_cut_selection_matches_jax(optimizer, params, use_kernel, lam):
    """Dense GraphCut through solve(): the JAX package's ids and n_evals;
    use_kernel=True runs the gc kernels' plain versions here and the Pallas
    kernels (interpret mode) on the JAX side."""
    fn = _port_fn("gc", use_kernel, lam)
    assert backend_name(fn) == ("cuda-gc" if use_kernel else "torch")
    port = solve(SelectionSpec(fn, BUDGET, optimizer, **params))
    _assert_same(port, _jax_result("gc", optimizer, params, use_kernel, lam), GC_TOL)


DISP_CASES = [("dsum", True), ("dsum", False), ("dmin", True), ("dmin", False), ("dminsum", False)]


@pytest.mark.parametrize("family,use_kernel", DISP_CASES)
@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_disparity_selection_matches_jax(optimizer, params, family, use_kernel):
    """The Disparity family through solve() with the family's stop default:
    ids and n_evals equal; gains to 1e-5, DisparityMin's bit for bit."""
    fn = _port_fn(family, use_kernel)
    want = {"dsum": "cuda-dsum", "dmin": "cuda-dmin"}.get(family) if use_kernel else "torch"
    assert backend_name(fn) == want
    port = solve(SelectionSpec(fn, BUDGET, optimizer, **params))
    assert int(port.order[0]) >= 0  # stopIfZeroGain=False: the empty set's 0 gain does not stop
    tol = None if family == "dmin" else SUM_TOL
    _assert_same(port, _jax_result(family, optimizer, params, use_kernel), tol)


def test_graph_cut_mf_over_a_dense_source_takes_the_gc_kernels():
    """GraphCutMF.from_dense routes to the dense gc kernels, as the JAX
    package's does, and selects what the JAX package selects."""
    sim = _gc_sim()
    fn = GraphCutMF.from_dense(sim, lam=0.3, use_kernel=True, device="cpu")
    assert backend_name(fn) == "cuda-gc"
    jfn = J.GraphCutMF.from_dense(jnp.asarray(sim), lam=0.3, use_kernel=True)
    for optimizer, params in OPTIMIZERS:
        jres = J.solve(J.SelectionSpec(jfn, BUDGET, optimizer, **params))
        _assert_same(solve(SelectionSpec(fn, BUDGET, optimizer, **params)),
                     (np.asarray(jres.order), np.asarray(jres.gains), int(jres.n_evals)), GC_TOL)


@pytest.mark.parametrize("family", ["gc", "dsum", "dmin", "dminsum"])
def test_evaluate_matches_jax(family):
    fn, jfn = _port_fn(family), _jax_fn(family)
    rng = np.random.default_rng(4)
    for size in (0, 1, 2, 7, N):
        mask = np.zeros(N, bool)
        mask[rng.choice(N, size, replace=False)] = True
        want = float(jfn.evaluate(jnp.asarray(mask)))
        got = float(fn.evaluate(torch.from_numpy(mask)))
        if family == "dmin":
            assert got == want
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("family", ["gc", "dsum", "dminsum"])
def test_gain_identity(family):
    """gains(state) = f(A + j) - f(A) after a few updates (for DisparityMin
    the gain is the surrogate, as in the JAX package, so it is left out)."""
    fn = _port_fn(family)
    state, mask = fn.init_state(), torch.zeros(N, dtype=torch.bool)
    for j in (4, 17, 33):
        state = fn.update(state, j)
        mask[j] = True
    g = full_sweep(fn, state)
    for j in (0, 9, 50):
        np.testing.assert_allclose(float(g[j]), float(fn.marginal_gain(mask, j)), rtol=1e-5, atol=1e-4)
    if family != "dsum":  # DisparitySum keeps no running value
        np.testing.assert_allclose(float(fn.evaluate_state(state)), float(fn.evaluate(mask)),
                                   rtol=1e-5, atol=1e-4)


def test_family_defaults_match_jax():
    """Disparity* default to stopIfZeroGain=False through SelectionSpec; an
    explicit flag wins; GraphCut keeps the library defaults."""
    for port_cls, family in ((DisparitySum, "dsum"), (DisparityMin, "dmin"),
                             (DisparityMinSum, "dminsum")):
        jcls = type(_jax_fn(family))
        assert family_defaults(port_cls) == J.family_defaults(jcls)
        assert SelectionSpec(_port_fn(family), 3).stop_if_zero is False
        assert SelectionSpec(_port_fn(family), 3, stopIfZeroGain=True).stop_if_zero is True
    assert SelectionSpec(_port_fn("gc"), 3).stop_if_zero is True
    with pytest.raises(TypeError, match="use_kernel"):
        SelectionSpec(_port_fn("dminsum"), 3, use_kernel=True)


# -- state hand-over (interop) ------------------------------------------------


def _jax_state(family, picks=(3, 20, 41)):
    jfn = _jax_fn(family)
    st = jfn.init_state()
    for j in picks:
        st = jfn.update(st, j)
    return jfn, st


_FROM_ARRAYS = {
    "gc": (gc_state_from_arrays, ("selsum", "value", "selmask")),
    "dsum": (dsum_state_from_arrays, ("selsum", "selmask")),
    "dmin": (dmin_state_from_arrays, ("mind", "curmin", "count", "selmask")),
    "dminsum": (dmin_sum_state_from_arrays, ("t", "selected", "count", "value")),
}


@pytest.mark.parametrize("family", ["gc", "dsum", "dmin", "dminsum"])
def test_state_round_trip(family):
    """A JAX state after three updates, handed over and back, is the same
    arrays; on it the port computes the JAX package's gains; and the port's
    own three updates reproduce it."""
    jfn, jst = _jax_state(family)
    convert, fields = _FROM_ARRAYS[family]
    arrays = {f: np.asarray(getattr(jst, f)) for f in fields}
    st = convert(*arrays.values(), device="cpu")
    back = state_to_arrays(st)
    assert set(back) == set(fields)
    for f in fields:
        np.testing.assert_array_equal(back[f], arrays[f].astype(back[f].dtype))
    fn = _port_fn(family)
    tol = dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(fn.gains(st).numpy(), np.asarray(jfn.gains(jst)), **tol)
    idx = torch.tensor([0, 7, 59])
    np.testing.assert_allclose(fn.gains_at(st, idx).numpy(),
                               np.asarray(jfn.gains_at(jst, jnp.asarray(idx.numpy()))), **tol)
    own = fn.init_state()
    for j in (3, 20, 41):
        own = fn.update(own, torch.tensor([j]))
    for f, a in state_to_arrays(own).items():
        np.testing.assert_allclose(a.astype(np.float64), arrays[f].astype(np.float64), **tol)


def test_use_kernel_none_resolves_to_torch_on_the_cpu():
    for fn in (_port_fn("gc"), _port_fn("dsum"), _port_fn("dmin")):
        assert backend_name(dataclasses.replace(fn, use_kernel=None)) == "torch"


def test_row_reduce_block_width_has_one_source():
    """The kernels' threads per row come from the plain version's THREADS
    (nvcc gets it as ROW_REDUCE_THREADS), so the two orders cannot drift."""
    from repro_torch.kernels import _build, row_reduce

    assert f"-DROW_REDUCE_THREADS={row_reduce.THREADS}" in _build.NVCC_FLAGS
    header = (_build.CSRC / "row_reduce.cuh").read_text()
    assert "constexpr int THREADS = ROW_REDUCE_THREADS;" in header
    assert str(row_reduce.THREADS) not in header.replace("50,000", "")


def test_row_reduce_staged_chunk_has_one_source():
    """The selected-columns kernel's staged chunk comes from the plain
    version's SEL_CHUNK (nvcc gets it as ROW_REDUCE_SEL_CHUNK), which the
    GPU tests cross with |A|; it holds whole rounds of a warp's 32 lanes."""
    from repro_torch.kernels import _build, row_reduce

    assert f"-DROW_REDUCE_SEL_CHUNK={row_reduce.SEL_CHUNK}" in _build.NVCC_FLAGS
    header = (_build.CSRC / "row_reduce.cuh").read_text()
    assert "constexpr int SEL_CHUNK = ROW_REDUCE_SEL_CHUNK;" in header
    assert row_reduce.SEL_CHUNK % row_reduce.WARP == 0
