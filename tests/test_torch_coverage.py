"""The port's coverage families against the JAX package on the CPU: the fb /
fb_at / sc / psc kernels' plain versions against the JAX Pallas kernels
(interpret mode) and oracles, fb_gains_at against fb_gains bit for bit,
FeatureBased / SetCover / ProbabilisticSetCover selections, update,
evaluate and evaluate_state, the SC/PSC information measures and the
state hand-over.

Inputs are numpy arrays from a seed, handed to both packages.  Bars: the
JAX package's own (tests/test_kernels.py:234,282,300,520): 1e-4 for the
feature-based sweep (a concave per element, summed in another order than
XLA's), 1e-5 for the gathered feature-based sweep and the set-cover sweeps.
Ids and n_evals must be equal; SetCover's unit-weight gains are integers,
exact in any order, so they must be equal too.  The information measures'
weights are products of a few fp32 factors, formed in another order than
XLA's prod: rtol 1e-6.  The CUDA kernels are held against these plain
versions on the card by tests/test_torch_gpu.py.
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
    FeatureBased,
    ProbabilisticSetCover,
    SelectionSpec,
    SetCover,
    backend_name,
    solve,
)
from repro_torch.core import info as port_info
from repro_torch.core.optimizers.backends import full_sweep
from repro_torch.interop import (
    fb_state_from_arrays,
    feature_based_from_arrays,
    probabilistic_set_cover_from_arrays,
    psc_state_from_arrays,
    result_to_numpy,
    sc_state_from_arrays,
    set_cover_from_arrays,
    state_to_arrays,
)
from repro_torch.kernels import ops
from repro_torch.kernels.fb_gains import fb_gains_plain

FB_TOL = dict(rtol=1e-4, atol=1e-4)
SC_TOL = dict(rtol=1e-5, atol=1e-5)
CONCAVES = ["sqrt", "log", "inverse"]
FB_SHAPES = [(8, 5), (128, 128), (130, 70), (300, 33)]  # tests/test_kernels.py:217
SC_SHAPES = [(8, 5), (100, 33), (128, 128), (257, 70), (300, 130)]  # tests/test_kernels.py:264
OPTIMIZERS = [
    ("NaiveGreedy", {}),
    ("LazyGreedy", {"screen_k": 1}),
    ("LazyGreedy", {"screen_k": 8}),
]
N, M, BUDGET = 60, 20, 10
_JAX: dict = {}


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the kernels' plain versions vs the Pallas kernels and the oracles --------


@pytest.mark.parametrize("concave", CONCAVES)
@pytest.mark.parametrize("shape", FB_SHAPES)
def test_fb_plain_matches_jax_kernel_and_oracle(shape, concave):
    n, F = shape
    rng = np.random.default_rng(n + F)
    feats = rng.uniform(0, 1, size=(n, F)).astype(np.float32)
    acc = rng.uniform(0, 2, size=(F,)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(F,)).astype(np.float32)
    got = ops.fb_gains(_t(feats), _t(acc), _t(w), concave).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.fb_gains(feats, acc, w, concave)), **FB_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.fb_gains_ref(feats, acc, w, concave)), **FB_TOL)


SUBSET_IDX = [
    np.array([0, 5, 47, 12], np.int32),  # plain gather
    np.array([3, 3, 3, 40, 40], np.int32),  # duplicates
    np.array([7, -1, 20, -1, -1], np.int32),  # padding slots
    np.array([47, 60, 99, 0], np.int32),  # idx >= n reads row n - 1
    np.arange(48, dtype=np.int32)[::-1].copy(),  # every row, reversed
]


@pytest.mark.parametrize("concave", CONCAVES)
@pytest.mark.parametrize("idx", SUBSET_IDX, ids=["gather", "dups", "pads", "clipped", "all"])
def test_fb_at_plain_matches_jax_and_equals_full_bit_for_bit(idx, concave):
    """The JAX package's contract (tests/test_kernels.py:503-526): the
    gathered sweep equals the full sweep bit for bit at the same index."""
    rng = np.random.default_rng(11)
    n, F = 48, 33
    feats = rng.uniform(0, 1, size=(n, F)).astype(np.float32)
    acc = rng.uniform(0, 3, size=(F,)).astype(np.float32)
    w = rng.uniform(0.2, 1.5, size=(F,)).astype(np.float32)
    got = ops.fb_gains_at(_t(feats), _t(acc), _t(w), _t(idx), concave)
    full = fb_gains_plain(_t(feats), _t(acc), _t(w), concave)
    keep = idx >= 0
    assert torch.equal(got[keep], full[np.minimum(idx[keep], n - 1)])
    assert bool((got[~keep] == NEG_INF).all())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.fb_gains_at(feats, acc, w, idx, concave)), **SC_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.fb_gains_at_ref(feats, acc, w, jnp.asarray(idx), concave)),
        **SC_TOL)


@pytest.mark.parametrize("concave", CONCAVES)
@pytest.mark.parametrize("idx", SUBSET_IDX, ids=["gather", "dups", "pads", "clipped", "all"])
def test_fb_at_takes_int32_and_int64_ids(idx, concave):
    """The engine hands int64 ids over, other callers int32: the wrapper
    takes both as they are, with equal results."""
    rng = np.random.default_rng(13)
    feats, acc, w = (_t(rng.uniform(0, 1, size=s).astype(np.float32))
                     for s in ((48, 33), (33,), (33,)))
    got32 = ops.fb_gains_at(feats, acc, w, _t(idx), concave)
    got64 = ops.fb_gains_at(feats, acc, w, _t(idx.astype(np.int64)), concave)
    assert torch.equal(got32, got64)


@pytest.mark.parametrize("shape", SC_SHAPES)
def test_sc_plain_matches_jax_kernel_and_oracle(shape):
    n, m = shape
    rng = np.random.default_rng(n * m)
    cover = rng.integers(0, 2, size=(n, m)).astype(np.float32)
    covered = (rng.uniform(size=m) < 0.4).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=m).astype(np.float32)
    got = ops.sc_gains(_t(cover), _t(covered), _t(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.sc_gains(cover, covered, w)), **SC_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.sc_gains_ref(cover, covered, w)), **SC_TOL)
    assert (got >= 0).all()  # gains of a monotone function


@pytest.mark.parametrize("shape", SC_SHAPES)
def test_psc_plain_matches_jax_kernel_and_oracle(shape):
    n, m = shape
    rng = np.random.default_rng(n * m + 1)
    probs = rng.uniform(0, 0.9, size=(n, m)).astype(np.float32)
    miss = rng.uniform(0, 1, size=m).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=m).astype(np.float32)
    got = ops.psc_gains(_t(probs), _t(miss), _t(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.psc_gains(probs, miss, w)), **SC_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.psc_gains_ref(probs, miss, w)), **SC_TOL)


def test_sc_unit_weights_are_exact():
    """A binary cover and covered with unit weights: every gain is the
    integer count of new concepts, whatever the order of the sum."""
    rng = np.random.default_rng(3)
    cover = rng.integers(0, 2, size=(257, 1000)).astype(np.float32)
    covered = (rng.uniform(size=1000) < 0.3).astype(np.float32)
    got = ops.sc_gains(_t(cover), _t(covered), torch.ones(1000)).numpy()
    np.testing.assert_array_equal(got, ((cover - covered) > 0).sum(axis=1).astype(np.float32))


# widths the sc kernel's vector warp layout treats apart (csrc/row_reduce.cuh):
# one concept; fewer than one 128-wide round of 32 lanes x 4; m % 4 != 0 (a
# short last chunk, the element loads); whole and ragged rounds
SC_M = [1, 3, 33, 100, 130, 1000, 1001]


def _sc_inputs(n, m, seed):
    rng = np.random.default_rng(seed)
    cover = rng.integers(0, 2, size=(n, m)).astype(np.float32)
    covered = rng.uniform(size=m).astype(np.float32)  # fractional
    w = rng.uniform(0.5, 2.0, size=m).astype(np.float32)
    return cover, covered, w


@pytest.mark.parametrize("m", SC_M)
def test_sc_plain_in_vector_layout_matches_jax(m):
    """The plain version, in the vector warp layout's order, with weights and
    a fractional covered, against the JAX kernel (interpret mode) and its
    oracle."""
    cover, covered, w = _sc_inputs(24, m, m)
    got = ops.sc_gains(_t(cover), _t(covered), _t(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.sc_gains(cover, covered, w)), **SC_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.sc_gains_ref(cover, covered, w)), **SC_TOL)


@pytest.mark.parametrize("m", SC_M)
def test_sc_plain_adds_in_the_vector_warp_order(m):
    """The plain version equals, bit for bit, a scalar fp32 walk of the
    kernel's order: lane l adds the terms of the 4-concept chunks l, l + 32,
    ... in order, then lane i takes lane i + h for h = 16, 8, 4, 2, 1."""
    cover, covered, w = _sc_inputs(5, m, m + 1)
    got = ops.sc_gains(_t(cover), _t(covered), _t(w)).numpy()
    f32 = np.float32
    for r in range(cover.shape[0]):
        lanes = [f32(0.0)] * 32
        for f in range(m):
            term = f32(max(f32(cover[r, f] - covered[f]), f32(0.0)) * w[f])
            lanes[(f // 4) % 32] = f32(lanes[(f // 4) % 32] + term)
        h = 16
        while h:
            lanes = [f32(lanes[i] + lanes[i + h]) for i in range(h)]
            h //= 2
        assert got[r] == lanes[0]


@pytest.mark.parametrize("m", SC_M)
def test_sc_plain_row_sum_does_not_depend_on_n(m):
    """A row's sum is the same bits swept alone, inside a larger sweep, or in
    a slice of it: the order depends on m alone."""
    cover, covered, w = _sc_inputs(257, m, m + 2)
    full = ops.sc_gains(_t(cover), _t(covered), _t(w))
    for lo, hi in ((0, 1), (100, 101), (3, 130), (256, 257)):
        assert torch.equal(ops.sc_gains(_t(cover[lo:hi]), _t(covered), _t(w)), full[lo:hi])


@pytest.mark.parametrize("m", SC_M)
def test_sc_unit_weights_are_exact_at_every_width(m):
    rng = np.random.default_rng(m + 3)
    cover = rng.integers(0, 2, size=(65, m)).astype(np.float32)
    covered = (rng.uniform(size=m) < 0.3).astype(np.float32)
    got = ops.sc_gains(_t(cover), _t(covered), torch.ones(m)).numpy()
    np.testing.assert_array_equal(got, ((cover - covered) > 0).sum(axis=1).astype(np.float32))


def test_coverage_wrappers_check_their_inputs():
    x, v = torch.rand((8, 6)), torch.rand(6)
    with pytest.raises(ValueError, match="concave"):
        ops.fb_gains(x, v, v, "cube")
    with pytest.raises(TypeError, match="float32"):
        ops.fb_gains(x.to(torch.bfloat16), v, v)  # bf16 feats are not ported
    with pytest.raises(TypeError, match="float32"):
        ops.sc_gains(x, v.double(), v)
    with pytest.raises(ValueError, match="does not match"):
        ops.psc_gains(x, torch.rand(5), v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sc_gains(torch.rand((6, 8)).T, v, v)
    with pytest.raises(ValueError, match="no columns"):
        ops.psc_gains(torch.rand((8, 0)), torch.rand(0), torch.rand(0))
    with pytest.raises(TypeError, match="idx"):
        ops.fb_gains_at(x, v, v, torch.tensor([0.0]))
    with pytest.raises(ValueError, match="no rows"):
        ops.fb_gains_at(torch.rand((0, 6)), v, v, torch.tensor([0]))


# -- selection against the JAX package ----------------------------------------


def _arrays(family):
    rng = np.random.default_rng({"fb": 0, "sc": 1, "psc": 2}[family])
    if family == "fb":
        return rng.uniform(0, 1, size=(N, M)).astype(np.float32)
    if family == "sc":
        return rng.integers(0, 2, size=(N, M)).astype(np.float32)
    return rng.uniform(0, 0.6, size=(N, M)).astype(np.float32)


def _jax_fn(family, concave="sqrt", use_kernel=False):
    key = (family, concave, use_kernel)
    if key not in _JAX:
        a = jnp.asarray(_arrays(family))
        if family == "fb":
            _JAX[key] = J.FeatureBased.from_features(a, concave=concave, use_kernel=use_kernel)
        elif family == "sc":
            _JAX[key] = J.SetCover.from_cover(a, use_kernel=use_kernel)
        else:
            _JAX[key] = J.ProbabilisticSetCover.from_probs(a, use_kernel=use_kernel)
    return _JAX[key]


def _port_fn(family, concave="sqrt", use_kernel=False):
    """The port's function over the JAX function's own arrays (interop)."""
    jfn = _jax_fn(family, concave, use_kernel)
    w = np.asarray(jfn.w)
    if family == "fb":
        return feature_based_from_arrays(np.asarray(jfn.feats), w, concave, use_kernel, "cpu")
    if family == "sc":
        return set_cover_from_arrays(np.asarray(jfn.cover), w, use_kernel, "cpu")
    return probabilistic_set_cover_from_arrays(np.asarray(jfn.log_miss), w, use_kernel, "cpu")


def _jax_result(family, concave, optimizer, params, use_kernel):
    key = ("res", family, concave, optimizer, tuple(params.items()), use_kernel)
    if key not in _JAX:
        res = J.solve(J.SelectionSpec(_jax_fn(family, concave, use_kernel), BUDGET, optimizer,
                                      **params))
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


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
@pytest.mark.parametrize("concave", CONCAVES)
def test_feature_based_selection_matches_jax(concave, optimizer, params, use_kernel):
    """FeatureBased through solve(): the JAX package's ids and n_evals;
    use_kernel=True runs the fb kernels' plain versions here and the Pallas
    kernels (interpret mode) on the JAX side."""
    fn = _port_fn("fb", concave, use_kernel)
    assert backend_name(fn) == ("cuda-fb" if use_kernel else "torch")
    port = solve(SelectionSpec(fn, BUDGET, optimizer, **params))
    _assert_same(port, _jax_result("fb", concave, optimizer, params, use_kernel), FB_TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
@pytest.mark.parametrize("family", ["sc", "psc"])
def test_set_cover_selection_matches_jax(family, optimizer, params, use_kernel):
    """SetCover (unit weights: gains equal exactly) and ProbabilisticSetCover
    (gains to 1e-5) through solve(): the JAX package's ids and n_evals."""
    fn = _port_fn(family, use_kernel=use_kernel)
    assert backend_name(fn) == (f"cuda-{family}" if use_kernel else "torch")
    port = solve(SelectionSpec(fn, BUDGET, optimizer, **params))
    _assert_same(port, _jax_result(family, "sqrt", optimizer, params, use_kernel),
                 None if family == "sc" else SC_TOL)


def test_from_constructors_match_jax():
    """from_features clamps at 0 and from_probs clips to [0, 1 - 1e-7] as the
    JAX package does; probs is its 1 - exp(log_miss)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(30, 12)).astype(np.float32)
    fb, jfb = FeatureBased.from_features(x, device="cpu"), J.FeatureBased.from_features(x)
    np.testing.assert_array_equal(fb.feats.numpy(), np.asarray(jfb.feats))
    np.testing.assert_array_equal(fb.w.numpy(), np.asarray(jfb.w))
    p = np.clip(rng.uniform(-0.2, 1.2, size=(30, 12)), -0.1, 1.0).astype(np.float32)
    psc, jpsc = ProbabilisticSetCover.from_probs(p, device="cpu"), J.ProbabilisticSetCover.from_probs(p)
    np.testing.assert_allclose(psc.log_miss.numpy(), np.asarray(jpsc.log_miss), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(psc.probs.numpy(), np.asarray(jpsc.probs), rtol=1e-6, atol=1e-7)
    assert bool((psc.probs <= 1.0 - 1e-7).all()) and bool((psc.probs >= 0.0).all())
    sc = SetCover.from_cover(p > 0.5, device="cpu")
    np.testing.assert_array_equal(sc.cover.numpy(), np.asarray(J.SetCover.from_cover(p > 0.5).cover))
    with pytest.raises(ValueError, match="concave"):
        FeatureBased.from_features(x, concave="cube", device="cpu")


FAMILIES = [("fb", c) for c in CONCAVES] + [("sc", "sqrt"), ("psc", "sqrt")]


@pytest.mark.parametrize("family,concave", FAMILIES)
def test_update_evaluate_and_state_match_jax(family, concave):
    """Three updates on both sides: the states, the gains on them (full and
    gathered), evaluate on masks of several sizes and evaluate_state."""
    fn, jfn = _port_fn(family, concave), _jax_fn(family, concave)
    st, jst = fn.init_state(), jfn.init_state()
    mask = np.zeros(N, bool)
    tol = dict(rtol=1e-5, atol=1e-5)
    for j in (4, 17, 33):
        st, jst = fn.update(st, torch.tensor([j])), jfn.update(jst, j)
        mask[j] = True
        for f, a in state_to_arrays(st).items():
            np.testing.assert_allclose(a, np.asarray(getattr(jst, f)), **tol)
        np.testing.assert_allclose(fn.gains(st).numpy(), np.asarray(jfn.gains(jst)), **tol)
        idx = np.array([0, 9, 59, 17], np.int32)
        np.testing.assert_allclose(fn.gains_at(st, _t(idx)).numpy(),
                                   np.asarray(jfn.gains_at(jst, jnp.asarray(idx))), **tol)
        np.testing.assert_allclose(float(fn.evaluate_state(st)), float(jfn.evaluate_state(jst)), **tol)
        np.testing.assert_allclose(float(fn.evaluate(_t(mask))), float(fn.evaluate_state(st)), **tol)
    rng = np.random.default_rng(4)
    for size in (0, 1, 2, 7, N):
        m = np.zeros(N, bool)
        m[rng.choice(N, size, replace=False)] = True
        np.testing.assert_allclose(float(fn.evaluate(_t(m))), float(jfn.evaluate(jnp.asarray(m))),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("family,concave", FAMILIES)
def test_gain_identity(family, concave):
    """full_sweep(state) = f(A + j) - f(A) after a few updates, on the
    kernel route (the plain versions here)."""
    fn = _port_fn(family, concave, use_kernel=True)
    state, mask = fn.init_state(), torch.zeros(N, dtype=torch.bool)
    for j in (4, 17, 33):
        state = fn.update(state, j)
        mask[j] = True
    g = full_sweep(fn, state)
    for j in (0, 9, 50):
        np.testing.assert_allclose(float(g[j]), float(fn.marginal_gain(mask, j)), rtol=1e-5, atol=1e-4)


# -- the SC / PSC information measures ----------------------------------------

NV, NQ, NP = 40, 4, 3  # ground, query and private rows, as tests/test_info.py lays them out


def _info_case(name):
    rng = np.random.default_rng(21)
    if name.startswith("sc"):
        data = rng.integers(0, 2, size=(NV + NQ + NP, 15)).astype(np.float32)
    else:
        data = rng.uniform(0, 0.8, size=(NV + NQ + NP, 15)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 15).astype(np.float32)
    q, p = data[NV : NV + NQ], data[NV + NQ :]
    extra = {"mi": (q,), "cg": (p,), "cmi": (q, p)}[name.split("_")[1]]
    return (data[:NV], w) + extra


@pytest.mark.parametrize("name", ["sc_mi", "sc_cg", "sc_cmi", "psc_mi", "psc_cg", "psc_cmi"])
def test_info_measures_match_jax(name):
    """Each measure is its base family reweighted: the weights to rtol 1e-6
    (module docstring), and a NaiveGreedy selection with the JAX package's
    ids; use_kernel is forwarded."""
    args = _info_case(name)
    jfn = getattr(J, name)(*args)
    fn = getattr(port_info, name)(*args, use_kernel=True, device="cpu")
    assert type(fn) is (SetCover if name.startswith("sc") else ProbabilisticSetCover)
    assert fn.use_kernel is True and backend_name(fn) == f"cuda-{name.split('_')[0]}"
    np.testing.assert_allclose(fn.w.numpy(), np.asarray(jfn.w), rtol=1e-6, atol=0)
    jres = J.solve(J.SelectionSpec(jfn, 8, "NaiveGreedy"))
    res = solve(SelectionSpec(fn, 8, "NaiveGreedy"))
    np.testing.assert_array_equal(res.order.numpy(), np.asarray(jres.order))
    np.testing.assert_allclose(res.gains.numpy(), np.asarray(jres.gains), rtol=1e-5, atol=1e-5)


# -- state hand-over (interop) ------------------------------------------------

_FROM_ARRAYS = {
    "fb": (fb_state_from_arrays, "acc"),
    "sc": (sc_state_from_arrays, "covered"),
    "psc": (psc_state_from_arrays, "miss"),
}


@pytest.mark.parametrize("family", ["fb", "sc", "psc"])
def test_state_round_trip(family):
    """A JAX state after three updates, handed over and back, is the same
    array, and on it the port computes the JAX package's gains; PSC's
    log_miss is handed over as it is, bit for bit."""
    jfn = _jax_fn(family)
    jst = jfn.init_state()
    for j in (3, 20, 41):
        jst = jfn.update(jst, j)
    convert, field = _FROM_ARRAYS[family]
    arr = np.asarray(getattr(jst, field))
    st = convert(arr, device="cpu")
    back = state_to_arrays(st)
    assert set(back) == {field}
    np.testing.assert_array_equal(back[field], arr)
    fn = _port_fn(family)
    np.testing.assert_allclose(fn.gains(st).numpy(), np.asarray(jfn.gains(jst)), rtol=1e-5, atol=1e-5)
    if family == "psc":
        np.testing.assert_array_equal(fn.log_miss.numpy(), np.asarray(jfn.log_miss))


def test_use_kernel_none_resolves_to_torch_on_the_cpu():
    for fn in (_port_fn("fb"), _port_fn("sc"), _port_fn("psc")):
        assert backend_name(dataclasses.replace(fn, use_kernel=None)) == "torch"


def test_torch_paths_stream_row_blocks(monkeypatch):
    """The torch paths hold one ROW_BLOCK of (n, m) temporaries at a time;
    the blocks' concatenation gives the unstreamed gains."""
    from repro_torch import common

    fns = [_port_fn("fb", "log"), _port_fn("sc"), _port_fn("psc")]
    idx = torch.arange(N - 1, -1, -1)
    want = []
    for fn in fns:
        st = fn.update(fn.init_state(), 5)
        want.append((fn.gains(st), fn.gains_at(st, idx)))
    monkeypatch.setattr(common, "ROW_BLOCK", 7)
    for fn, (g, ga) in zip(fns, want):
        st = fn.update(fn.init_state(), 5)
        np.testing.assert_allclose(fn.gains(st).numpy(), g.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(fn.gains_at(st, idx).numpy(), ga.numpy(), rtol=1e-6, atol=1e-6)
