"""The port's LogDet and information measures against the JAX package on the
CPU: LogDet (with the drop-mode write past ``max_select``), the Facility
Location, Graph Cut and LogDet MI / CG / CMI closed forms, the generic
combinators, Concave-Over-Modular, the ``maximize`` shim, the engines' tree
select over tuple and bare-tensor states, and the state hand-over.

Inputs are numpy arrays from a seed, handed to both packages.  Every
selection must pick the JAX package's ids with its n_evals.  Gain bars:
1e-5 for FL, GC and COM (fp32 sums in another order than XLA's; the gc
kernel's plain version, which sums each row in the kernel's order, is held
to the JAX package's gc-kernel bar, 1e-4).  For LogDet and its Schur forms
the bar is measured: on these inputs plain LogDet's gains equal the JAX
package's, and the Schur forms' (an fp32 solve that the two packages round
differently) differ by at most 9e-8 absolute, 4.9e-6 relative, over every
selection below; they are held at 1e-5, which also covers the generic
combinators over a LogDet base.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro_torch.core import (
    FLCG,
    FLCMI,
    FLQMI,
    FLVMI,
    GCMI,
    ConcaveOverModular,
    FacilityLocation,
    FLState,
    LogDet,
    SelectionSpec,
    backend_name,
    gccg,
    gccmi,
    generic_cg,
    generic_cmi,
    generic_mi,
    logdet_cg,
    logdet_cmi,
    logdet_mi,
    maximize,
    solve,
)
from repro_torch.core.optimizers.greedy import _where_state
from repro_torch.interop import (
    com_from_arrays,
    flcg_from_arrays,
    flcmi_from_arrays,
    flqmi_from_arrays,
    flvmi_from_arrays,
    gcmi_from_arrays,
    log_det_from_arrays,
    log_det_state_from_arrays,
    result_to_numpy,
    state_from_arrays,
    state_to_arrays,
)

NV, NQ, NP, D, BUDGET = 30, 5, 4, 6, 8
TOL = dict(rtol=1e-5, atol=1e-5)
GC_KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
LOGDET_TOL = dict(rtol=1e-5, atol=1e-5)
SCHUR_TOL = dict(rtol=1e-5, atol=1e-5)
OPTIMIZERS = [("NaiveGreedy", {}), ("LazyGreedy", {"screen_k": 1}), ("LazyGreedy", {"screen_k": 8})]
TWO_OPTIMIZERS = OPTIMIZERS[::2]  # NaiveGreedy and LazyGreedy screen_k 8
_CACHE: dict = {}


def _data():
    if "data" not in _CACHE:
        rng = np.random.default_rng(0)
        V, Q, P = (rng.normal(size=(m, D)).astype(np.float32) for m in (NV, NQ, NP))
        ck = lambda a, b=None: np.asarray(J.create_kernel(a, b, metric="cosine"))  # noqa: E731
        _CACHE["data"] = dict(S=ck(V), S_vq=ck(V, Q), S_vp=ck(V, P), S_qv=ck(Q, V),
                              V=V, Q=Q, P=P)
    return _CACHE["data"]


def _logdet_blocks():
    """The JAX test's well-conditioned extended kernel (tests/test_info.py:
    156-167): 0.4 x the cosine kernel over V ∪ Q ∪ P, diagonal 1.75."""
    if "ld" not in _CACHE:
        d = _data()
        Sx, q_idx, p_idx = J.build_extended_kernel(d["V"], d["Q"], d["P"], metric="cosine")
        Sx = np.asarray(Sx) * 0.4
        np.fill_diagonal(Sx, 1.75)
        q, p = slice(NV, NV + NQ), slice(NV + NQ, NV + NQ + NP)
        _CACHE["ld"] = dict(Sx=Sx, q_idx=np.asarray(q_idx), p_idx=np.asarray(p_idx),
                            S=Sx[:NV, :NV], S_vq=Sx[:NV, q], S_qq=Sx[q, q], S_vp=Sx[:NV, p],
                            S_pp=Sx[p, p], S_qp=Sx[q, p])
    return _CACHE["ld"]


def _solve_both(name, jfn, fn, optimizer, params, tol, budget=BUDGET, **stops):
    key = (name, optimizer, tuple(sorted(params.items())), budget, tuple(sorted(stops.items())))
    if key not in _CACHE:
        r = J.solve(J.SelectionSpec(jfn, budget, optimizer, **params, **stops))
        _CACHE[key] = (np.asarray(r.order), np.asarray(r.gains), int(r.n_evals))
    order, gains, n_evals = _CACHE[key]
    got = result_to_numpy(solve(SelectionSpec(fn, budget, optimizer, **params, **stops)))
    np.testing.assert_array_equal(got[0], order)
    assert got[2] == n_evals
    np.testing.assert_allclose(got[1], gains, **tol)
    return got


# -- LogDet --------------------------------------------------------------------


@pytest.mark.parametrize("max_select", [None, 3])
@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_log_det_selection_matches_jax(optimizer, params, max_select):
    """max_select = 3 under a budget of 8: from the fourth pick on, both
    packages drop the Cholesky column write (the JAX package's
    ``.at[:, count].set(e, mode="drop")``)."""
    S = _logdet_blocks()["S"]
    jfn = J.LogDet.from_kernel(jnp.asarray(S), max_select)
    fn = LogDet.from_kernel(S, max_select, device="cpu")
    got = _solve_both(f"logdet{max_select}", jfn, fn, optimizer, params, LOGDET_TOL)
    assert (got[0] >= 0).sum() == BUDGET


def test_log_det_update_drops_the_write_past_max_select():
    S = _logdet_blocks()["S"]
    fn = LogDet.from_kernel(S, 2, device="cpu")
    state = fn.init_state()
    for j in (3, 11, 20):
        new = fn.update(state, j)
        assert new is not state and new.C is not state.C  # out of place
        state = new
    assert int(state.count) == 3 and state.count.dtype == torch.int32
    # the third column was never written: C has two columns
    assert state.C.shape == (NV, 2)
    jfn = J.LogDet.from_kernel(jnp.asarray(S), 2)
    js = jfn.init_state()
    for j in (3, 11, 20):
        js = jfn.update(js, jnp.asarray(j))
    np.testing.assert_allclose(state.C.numpy(), np.asarray(js.C), **LOGDET_TOL)
    np.testing.assert_allclose(state.d2.numpy(), np.asarray(js.d2), **LOGDET_TOL)
    np.testing.assert_allclose(float(state.value), float(js.value), **LOGDET_TOL)


def test_log_det_evaluate_and_state_hand_over():
    S = _logdet_blocks()["S"]
    jfn = J.LogDet.from_kernel(jnp.asarray(S))
    fn = log_det_from_arrays(np.asarray(jfn.L), jfn.max_select, device="cpu")
    rng = np.random.default_rng(1)
    for k in (0, 1, 4, 9):
        mask = np.zeros(NV, bool)
        mask[rng.choice(NV, size=k, replace=False)] = True
        np.testing.assert_allclose(float(fn.evaluate(torch.from_numpy(mask))),
                                   float(jfn.evaluate(jnp.asarray(mask))), **LOGDET_TOL)
    js, state = jfn.init_state(), fn.init_state()
    for j in (4, 17, 9):
        js, state = jfn.update(js, jnp.asarray(j)), fn.update(state, j)
    mask = np.zeros(NV, bool)
    mask[[4, 17, 9]] = True
    np.testing.assert_allclose(float(fn.evaluate_state(state)),
                               float(fn.evaluate(torch.from_numpy(mask))), **LOGDET_TOL)
    handed = log_det_state_from_arrays(np.asarray(js.C), np.asarray(js.d2), js.count, js.value,
                                       device="cpu")
    generic = state_from_arrays(js, fn.init_state())
    for s in (handed, generic):
        assert s.count.dtype == torch.int32 and int(s.count) == 3
        np.testing.assert_allclose(fn.gains(s).numpy(), fn.gains(state).numpy(), **LOGDET_TOL)
    back = state_to_arrays(state)
    assert set(back) == {"C", "d2", "count", "value"}


# -- Facility-Location measures -------------------------------------------------


def _fl_pair(kind, eta=1.0, nu=1.0):
    d = _data()
    if kind == "flvmi":
        return (J.FLVMI.build(d["S"], d["S_vq"], eta=eta),
                FLVMI.build(d["S"], d["S_vq"], eta=eta, device="cpu"))
    if kind == "flqmi":
        return J.FLQMI.build(d["S_qv"], eta=eta), FLQMI.build(d["S_qv"], eta=eta, device="cpu")
    if kind == "flcg":
        return (J.FLCG.build(d["S"], d["S_vp"], nu=nu),
                FLCG.build(d["S"], d["S_vp"], nu=nu, device="cpu"))
    return (J.FLCMI.build(d["S"], d["S_vq"], d["S_vp"], eta=eta, nu=nu),
            FLCMI.build(d["S"], d["S_vq"], d["S_vp"], eta=eta, nu=nu, device="cpu"))


FL_KINDS = ["flvmi", "flqmi", "flcg", "flcmi"]


@pytest.mark.parametrize("kind", FL_KINDS)
@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_fl_measure_selection_matches_jax(optimizer, params, kind):
    jfn, fn = _fl_pair(kind, eta=0.8, nu=0.6)
    assert backend_name(fn) == "torch"
    _solve_both(kind, jfn, fn, optimizer, params, TOL, stopIfZeroGain=False)


def test_fl_measures_from_arrays_equal_build():
    converters = {
        "flvmi": lambda j: flvmi_from_arrays(np.asarray(j.sim), np.asarray(j.qmax), device="cpu"),
        "flqmi": lambda j: flqmi_from_arrays(np.asarray(j.sim_qv), np.asarray(j.modular),
                                             device="cpu"),
        "flcg": lambda j: flcg_from_arrays(np.asarray(j.sim), np.asarray(j.pmax), device="cpu"),
        "flcmi": lambda j: flcmi_from_arrays(np.asarray(j.sim), np.asarray(j.qmax),
                                             np.asarray(j.pmax), device="cpu"),
    }
    for kind, conv in converters.items():
        jfn, fn = _fl_pair(kind, eta=0.8, nu=0.6)
        handed = conv(jfn)
        state = fn.update(fn.init_state(), 7)
        np.testing.assert_allclose(handed.gains(state).numpy(), fn.gains(state).numpy(), **TOL)
        js = jfn.update(jfn.init_state(), jnp.asarray(7))
        np.testing.assert_allclose(fn.gains(state).numpy(), np.asarray(jfn.gains(js)), **TOL)


@pytest.mark.parametrize("kind", FL_KINDS)
def test_fl_measure_gain_identity_and_evaluate(kind):
    """gains(state)[j] == f(A + j) - f(A) along a selection
    (tests/test_info.py:245's identity), and evaluate against the JAX
    package's."""
    jfn, fn = _fl_pair(kind, eta=0.8, nu=0.6)
    state, mask = fn.init_state(), torch.zeros(NV, dtype=torch.bool)
    for j in (2, 19, 7, 25):
        g = fn.gains(state)
        np.testing.assert_allclose(float(g[j]), float(fn.marginal_gain(mask, j)), **TOL)
        np.testing.assert_allclose(fn.gains_at(state, torch.tensor([j, -1]))[0].item(),
                                   float(g[j]), rtol=0, atol=0)
        state, mask[j] = fn.update(state, j), True
        np.testing.assert_allclose(float(fn.evaluate(mask)),
                                   float(jfn.evaluate(jnp.asarray(mask.numpy()))), **TOL)
        if kind != "flqmi":
            np.testing.assert_allclose(float(fn.evaluate_state(state)), float(fn.evaluate(mask)),
                                       **TOL)


def test_flqmi_saturates_at_eta_zero():
    """tests/test_info.py:235: at eta = 0, after |Q| picks the gains collapse."""
    _, fn = _fl_pair("flqmi", eta=0.0)
    gains = [g for _, g in solve(SelectionSpec(fn, 8, stopIfZeroGain=False)).as_list()]
    assert gains[NQ] < 0.25 * gains[0] + 1e-6


def test_flcmi_without_private_is_flvmi():
    """tests/test_info.py:274: FLCMI with an all-zero private kernel is FLVMI."""
    d = _data()
    cmi = FLCMI.build(d["S"], d["S_vq"], np.zeros((NV, 1), np.float32), device="cpu")
    vmi = FLVMI.build(d["S"], d["S_vq"], device="cpu")
    a, b = solve(SelectionSpec(cmi, BUDGET)), solve(SelectionSpec(vmi, BUDGET))
    assert torch.equal(a.order, b.order) and torch.equal(a.gains, b.gains)
    mask = torch.zeros(NV, dtype=torch.bool)
    mask[a.order[a.order >= 0]] = True
    assert float(cmi.evaluate(mask)) == float(vmi.evaluate(mask))


# -- Graph-Cut measures ---------------------------------------------------------


@pytest.mark.parametrize("optimizer,params", TWO_OPTIMIZERS)
def test_gcmi_and_gccmi_selection_match_jax(optimizer, params):
    d = _data()
    fn = GCMI.build(d["S_vq"], lam=0.5, device="cpu")
    assert isinstance(fn.init_state(), torch.Tensor) and fn.init_state().dim() == 0
    got = _solve_both("gcmi", J.GCMI.build(d["S_vq"], lam=0.5), fn, optimizer, params, TOL)
    cmi = gccmi(d["S_vq"], lam=0.5, device="cpu")
    np.testing.assert_array_equal(result_to_numpy(solve(SelectionSpec(cmi, BUDGET, optimizer,
                                                                      **params)))[0], got[0])
    # pure retrieval (tests/test_info.py:245): the top-k of the query sums
    assert list(got[0]) == list(np.argsort(-d["S_vq"].sum(axis=1), kind="stable")[:BUDGET])
    handed = gcmi_from_arrays(np.asarray(J.GCMI.build(d["S_vq"], lam=0.5).qsum), device="cpu")
    np.testing.assert_allclose(handed.qsum.numpy(), fn.qsum.numpy(), **TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("optimizer,params", TWO_OPTIMIZERS)
def test_gccg_selection_matches_jax(optimizer, params, use_kernel):
    """gccg is a port GraphCut: use_kernel=True runs the gc kernels' plain
    versions here (the CUDA kernels on the card); the JAX side is its
    memoized GraphCut."""
    d = _data()
    fn = gccg(d["S"], d["S_vp"], lam=0.4, nu=0.7, use_kernel=use_kernel, device="cpu")
    assert backend_name(fn) == ("cuda-gc" if use_kernel else "torch")
    jfn = J.gccg(d["S"], d["S_vp"], lam=0.4, nu=0.7)
    _solve_both("gccg", jfn, fn, optimizer, params, GC_KERNEL_TOL if use_kernel else TOL,
                stopIfZeroGain=False, stopIfNegativeGain=False)


# -- LogDet measures --------------------------------------------------------------


def _logdet_measures():
    b = _logdet_blocks()
    ms = dict(max_select=NV)
    return {
        "mi": (J.logdet_mi(b["S"], b["S_vq"], b["S_qq"], eta=0.9, **ms),
               logdet_mi(b["S"], b["S_vq"], b["S_qq"], eta=0.9, device="cpu", **ms)),
        "cg": (J.logdet_cg(b["S"], b["S_vp"], b["S_pp"], nu=0.8, **ms),
               logdet_cg(b["S"], b["S_vp"], b["S_pp"], nu=0.8, device="cpu", **ms)),
        "cmi": (J.logdet_cmi(b["S"], b["S_vq"], b["S_qq"], b["S_vp"], b["S_pp"], b["S_qp"],
                             eta=0.9, nu=0.8, **ms),
                logdet_cmi(b["S"], b["S_vq"], b["S_qq"], b["S_vp"], b["S_pp"], b["S_qp"],
                           eta=0.9, nu=0.8, device="cpu", **ms)),
    }


@pytest.mark.parametrize("kind", ["mi", "cg", "cmi"])
@pytest.mark.parametrize("optimizer,params", TWO_OPTIMIZERS)
def test_logdet_measure_selection_matches_jax(optimizer, params, kind):
    jfn, fn = _logdet_measures()[kind]
    _solve_both(f"logdet_{kind}", jfn, fn, optimizer, params, SCHUR_TOL,
                stopIfZeroGain=False, stopIfNegativeGain=False)


def test_logdet_schur_kernels_match_jax():
    for kind, (jfn, fn) in _logdet_measures().items():
        pairs = [(jfn, fn)] if kind == "cg" else [(jfn.f1, fn.f1), (jfn.f2, fn.f2)]
        for j, p in pairs:
            np.testing.assert_allclose(p.L.numpy(), np.asarray(j.L), **SCHUR_TOL)


# -- generic combinators ------------------------------------------------------------


def _generic(kind, family):
    b = _logdet_blocks()
    if family == "fl":
        Sx = b["Sx"] / 0.4  # a plain cosine similarity over V ∪ Q ∪ P, rows = V
        np.fill_diagonal(Sx, 1.0)
        jbase, base = J.FacilityLocation.from_kernel(Sx[:NV]), FacilityLocation.from_kernel(
            Sx[:NV], device="cpu")
    else:
        n = NV + NQ + NP
        jbase, base = J.LogDet.from_kernel(b["Sx"], n), LogDet.from_kernel(b["Sx"], n, device="cpu")
    q, p = b["q_idx"], b["p_idx"]
    if kind == "mi":
        return J.generic_mi(jbase, q, NV), generic_mi(base, q, NV)
    if kind == "cg":
        return J.generic_cg(jbase, p, NV), generic_cg(base, p, NV)
    return J.generic_cmi(jbase, q, p, NV), generic_cmi(base, q, p, NV)


@pytest.mark.parametrize("family", ["fl", "logdet"])
@pytest.mark.parametrize("kind", ["mi", "cg", "cmi"])
@pytest.mark.parametrize("optimizer,params", TWO_OPTIMIZERS)
def test_generic_combinator_selection_matches_jax(optimizer, params, kind, family):
    jfn, fn = _generic(kind, family)
    tol = TOL if family == "fl" else SCHUR_TOL
    _solve_both(f"generic_{kind}_{family}", jfn, fn, optimizer, params, tol,
                stopIfZeroGain=False, stopIfNegativeGain=False)
    mask = np.zeros(NV, bool)
    mask[[1, 8, 13, 22]] = True
    np.testing.assert_allclose(float(fn.evaluate(torch.from_numpy(mask))),
                               float(jfn.evaluate(jnp.asarray(mask))), **tol)


def test_difference_state_is_a_tuple_handed_over():
    jfn, fn = _generic("mi", "fl")
    js, state = jfn.init_state(), fn.init_state()
    assert isinstance(state, tuple) and len(state) == 2
    for j in (3, 12):
        js, state = jfn.update(js, jnp.asarray(j)), fn.update(state, j)
    handed = state_from_arrays(js, fn.init_state())
    assert isinstance(handed, tuple) and isinstance(handed[0], FLState)
    np.testing.assert_allclose(fn.gains(handed).numpy(), fn.gains(state).numpy(), **TOL)
    back = state_to_arrays(state)
    assert isinstance(back, tuple) and set(back[0]) == {"curmax"}


# -- Concave-Over-Modular ------------------------------------------------------------


@pytest.mark.parametrize("concave", ["sqrt", "log", "inverse"])
@pytest.mark.parametrize("optimizer,params", TWO_OPTIMIZERS)
def test_com_selection_matches_jax(optimizer, params, concave):
    d = _data()
    jfn = J.ConcaveOverModular.build(d["S_vq"], eta=0.5, concave=concave)
    fn = ConcaveOverModular.build(d["S_vq"], eta=0.5, concave=concave, device="cpu")
    assert fn.init_state().shape == (NQ,)
    _solve_both(f"com_{concave}", jfn, fn, optimizer, params, TOL)
    handed = com_from_arrays(np.asarray(jfn.sim_vq), np.asarray(jfn.modular), concave,
                             device="cpu")
    js = jfn.update(jfn.init_state(), jnp.asarray(4))
    state = state_from_arrays(np.asarray(js), fn.init_state())
    np.testing.assert_allclose(handed.gains(state).numpy(), np.asarray(jfn.gains(js)), **TOL)


def test_com_gain_identity():
    """tests/test_info.py:258."""
    d = _data()
    fn = ConcaveOverModular.build(d["S_vq"], eta=0.5, device="cpu")
    state, mask = fn.init_state(), torch.zeros(NV, dtype=torch.bool)
    for j in (2, 7, 4):
        np.testing.assert_allclose(float(fn.gains(state)[j]), float(fn.marginal_gain(mask, j)),
                                   rtol=1e-4, atol=1e-5)
        state, mask[j] = fn.update(state, j), True


# -- maximize and the engines' tree select ---------------------------------------------


def test_maximize_shim_matches_jax_and_warns_once():
    d = _data()
    fn = FLVMI.build(d["S"], d["S_vq"], device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = maximize(fn, 6, "LazyGreedy", screen_k=4)
    assert [w.category for w in caught] == [DeprecationWarning]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = J.maximize(J.FLVMI.build(d["S"], d["S_vq"]), 6, "LazyGreedy", screen_k=4)
        res = maximize(fn, 6, return_result=True)
        with pytest.raises(TypeError, match="stopIfZeroGian"):
            maximize(fn, 3, stopIfZeroGian=False)
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([g for _, g in got], [g for _, g in want], **TOL)
    assert res.order.shape == (6,)


def test_where_state_selects_over_the_state_tree():
    pred_t, pred_f = torch.tensor([True]), torch.tensor([False])
    old = (torch.zeros(()), FLState(curmax=torch.zeros(3), n_rows=3), [torch.zeros((2, 2))])
    new = (torch.ones(()), FLState(curmax=torch.ones(3), n_rows=99), [torch.ones((2, 2))])
    took, kept = _where_state(pred_t, new, old), _where_state(pred_f, new, old)
    assert isinstance(took, tuple) and isinstance(took[2], list)
    assert float(took[0]) == 1.0 and took[0].shape == () and float(kept[0]) == 0.0
    assert torch.equal(took[1].curmax, torch.ones(3)) and took[1].n_rows == 3
    assert torch.equal(kept[2][0], torch.zeros((2, 2))) and torch.equal(took[2][0],
                                                                      torch.ones((2, 2)))
    # a dataclass state is rebuilt field by field, as before
    assert dataclasses.is_dataclass(took[1]) and type(took[1]) is FLState
