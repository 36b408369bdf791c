"""Shared helpers of the port's serving tests (tests/test_torch_serving.py,
test_torch_resilience.py, test_torch_async_serve.py, test_torch_sessions.py):
one function per served family built from numpy draws in both packages,
and the two ways a served answer is held.

- ``same``: bit identity with the port's own sequential solve (ids, gains,
  ``n_evals``, value).
- ``near_ref``: ids and ``n_evals`` equal to the JAX package's *sequential*
  solve over the same arrays, gains within the family's ROADMAP bar (the
  JAX package's served gains can part from its sequential ones by an ulp,
  FeatureBased, so its served route is not the yardstick).
"""
import numpy as np
import torch

from repro.core import FacilityLocationMF as JFacilityLocationMF
from repro.core import GraphCutMF as JGraphCutMF
from repro.core import create_kernel as jcreate_kernel
from repro.core import knn_from_features as jknn_from_features
from repro.launch.serve import _random_function as j_random_function
from repro_torch.core import FacilityLocationMF, GraphCutMF
from repro_torch.interop import (
    disparity_min_from_arrays,
    disparity_sum_from_arrays,
    facility_location_from_arrays,
    feature_based_from_arrays,
    flcg_from_arrays,
    flcmi_from_arrays,
    flqmi_from_arrays,
    flvmi_from_arrays,
    gcmi_from_arrays,
    graph_cut_from_arrays,
    log_det_from_arrays,
    probabilistic_set_cover_from_arrays,
    result_to_numpy,
    set_cover_from_arrays,
)

CPU = "cpu"

# every family with a padder, by kind (a "_kernel" suffix builds the port's
# function with use_kernel=True: its CUDA kernels' plain versions on the
# CPU; "_rep" builds a FacilityLocationMF over REP_ROWS represented rows,
# apart from its n candidates), with its gain bar against the JAX package
# (ROADMAP queue 3)
FAMILIES = {
    "fl": 1e-5, "fl_kernel": 1e-5, "gc": 1e-4, "gc_kernel": 1e-4, "fb": 1e-4,
    "fb_kernel": 1e-4, "sc": 1e-5, "sc_kernel": 1e-5, "psc": 1e-5, "psc_kernel": 1e-5,
    "dsum": 1e-5, "dsum_kernel": 1e-5, "dmin": 1e-5, "dmin_kernel": 1e-5, "logdet": 1e-5,
    "gcmi": 1e-5, "flqmi": 1e-5, "flvmi": 1e-5, "flcg": 1e-5, "flcmi": 1e-5,
    "flmf": 2e-5, "flmf_kernel": 2e-5, "flmf_dense": 2e-5, "flmf_knn": 1e-5,
    "flmf_rep": 2e-5, "flmf_knn_rep": 1e-5,
    "gcmf": 2e-5, "gcmf_kernel": 2e-5, "gcmf_dense": 2e-5, "gcmf_knn": 1e-5,
}

REP_ROWS = 6

# the dispersion families' empty-set gain is 0: they run with stopping off
NOSTOP = ("dsum", "dmin")


def stops(kind: str) -> dict:
    stop = not kind.startswith(NOSTOP)
    return {"stopIfZeroGain": stop, "stopIfNegativeGain": stop}


def _measure(kind, rng, n):
    from repro.core import FLCG, FLCMI, FLVMI

    x = rng.normal(size=(n, 8)).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    p = rng.normal(size=(4, 8)).astype(np.float32)
    S = np.asarray(jcreate_kernel(x, metric="euclidean"))
    Sq = np.asarray(jcreate_kernel(x, q, metric="euclidean"))
    Sp = np.asarray(jcreate_kernel(x, p, metric="euclidean"))
    if kind == "flvmi":
        j = FLVMI.build(S, Sq)
        return flvmi_from_arrays(np.asarray(j.sim), np.asarray(j.qmax), CPU), j
    if kind == "flcg":
        j = FLCG.build(S, Sp)
        return flcg_from_arrays(np.asarray(j.sim), np.asarray(j.pmax), CPU), j
    j = FLCMI.build(S, Sq, Sp)
    return flcmi_from_arrays(np.asarray(j.sim), np.asarray(j.qmax), np.asarray(j.pmax), CPU), j


def _rep_knn(rng, n):
    """(REP_ROWS, 4) distinct neighbour ids among n columns and their weights."""
    ind = np.stack([rng.choice(n, size=4, replace=False) for _ in range(REP_ROWS)])
    return ind.astype(np.int32), rng.uniform(0, 1, size=ind.shape).astype(np.float32)


def _matrix_free(kind, rng, n, uk):
    x = rng.normal(size=(n, 8)).astype(np.float32)
    if kind == "flmf_rep":
        r = rng.normal(size=(REP_ROWS, 8)).astype(np.float32)
        return (FacilityLocationMF.from_features(r, x, metric="cosine", use_kernel=uk, device=CPU),
                JFacilityLocationMF.from_features(r, x, metric="cosine"))
    if kind == "flmf_knn_rep":
        ind, w = _rep_knn(rng, n)
        return (FacilityLocationMF.from_knn(ind, w, n_cols=n, device=CPU),
                JFacilityLocationMF.from_knn(ind, w, n_cols=n))
    fl = kind.startswith("flmf")
    P, J = (FacilityLocationMF, JFacilityLocationMF) if fl else (GraphCutMF, JGraphCutMF)
    lam = {} if fl else {"lam": 0.4}
    if kind.endswith("_dense"):
        S = np.asarray(jcreate_kernel(x, metric="cosine"))
        return P.from_dense(S, **lam, device=CPU), J.from_dense(S, **lam)
    if kind.endswith("_knn"):
        src = jknn_from_features(x, 6, metric="rbf")
        ind, w = np.asarray(src.indices), np.asarray(src.weights)
        return P.from_knn(ind, w, **lam, device=CPU), J.from_knn(ind, w, **lam)
    return (P.from_features(x, metric="cosine", **lam, use_kernel=uk, device=CPU),
            J.from_features(x, metric="cosine", **lam))


def pair(kind: str, rng, n: int):
    """(port function on the CPU, JAX function) of one family over the same
    numpy draws: the JAX CLI's random instance (launch/serve.py), or the
    FL measures and matrix-free sources built here."""
    base = kind.removesuffix("_kernel")
    uk = kind.endswith("_kernel")
    if base in ("flvmi", "flcg", "flcmi"):
        return _measure(base, rng, n)
    if base.startswith(("flmf", "gcmf")):
        return _matrix_free(base, rng, n, uk)
    j = j_random_function(base, n, rng)

    def a(name):
        return np.asarray(getattr(j, name))

    if base == "fl":
        return facility_location_from_arrays(a("sim"), uk, CPU), j
    if base == "gc":
        return graph_cut_from_arrays(a("sim_ground"), a("total"), a("lam"), uk, CPU), j
    if base == "fb":
        return feature_based_from_arrays(a("feats"), a("w"), j.concave, uk, CPU), j
    if base == "sc":
        return set_cover_from_arrays(a("cover"), a("w"), uk, CPU), j
    if base == "psc":
        return probabilistic_set_cover_from_arrays(a("log_miss"), a("w"), uk, CPU), j
    if base == "dsum":
        return disparity_sum_from_arrays(a("dist"), uk, CPU), j
    if base == "dmin":
        return disparity_min_from_arrays(a("dist"), uk, CPU), j
    if base == "flqmi":
        return flqmi_from_arrays(a("sim_qv"), a("modular"), CPU), j
    if base == "gcmi":
        return gcmi_from_arrays(a("qsum"), CPU), j
    if base == "logdet":
        return log_det_from_arrays(a("L"), j.max_select, CPU), j
    raise KeyError(kind)


def port_fn(kind: str, rng, n: int):
    """The port's function of one family from numpy draws, built by the
    port alone (no JAX: for tests that hold served against sequential only)."""
    import dataclasses

    from repro_torch.core import FLCG, FLCMI, FLVMI, create_kernel, knn_from_features
    from repro_torch.launch.serve import _random_function

    base = kind.removesuffix("_kernel")
    uk = kind.endswith("_kernel")
    x = rng.normal(size=(n, 8)).astype(np.float32)
    if base in ("flvmi", "flcg", "flcmi"):
        S = create_kernel(x, metric="euclidean", device=CPU)
        q = create_kernel(x, rng.normal(size=(5, 8)).astype(np.float32), metric="euclidean",
                          device=CPU)
        if base == "flvmi":
            return FLVMI.build(S, q)
        if base == "flcg":
            return FLCG.build(S, q)
        return FLCMI.build(S, q, q[:, :3])
    if base == "flmf_rep":
        r = rng.normal(size=(REP_ROWS, 8)).astype(np.float32)
        return FacilityLocationMF.from_features(r, x, metric="cosine", use_kernel=uk, device=CPU)
    if base == "flmf_knn_rep":
        ind, w = _rep_knn(rng, n)
        return FacilityLocationMF.from_knn(ind, w, n_cols=n, device=CPU)
    if base.startswith(("flmf", "gcmf")):
        P = FacilityLocationMF if base.startswith("flmf") else GraphCutMF
        lam = {} if base.startswith("flmf") else {"lam": 0.4}
        if base.endswith("_dense"):
            return P.from_dense(create_kernel(x, metric="cosine", device=CPU), **lam)
        if base.endswith("_knn"):
            src = knn_from_features(x, 6, metric="rbf", device=CPU)
            return P.from_knn(src.indices, src.weights, **lam)
        return P.from_features(x, metric="cosine", **lam, use_kernel=uk, device=CPU)
    fn = _random_function(base, n, rng, CPU)
    return dataclasses.replace(fn, use_kernel=True) if uk else fn


def same(a, b, what=""):
    """Bit identity of two port results (ids, gains, n_evals, value); either
    may be a GreedyResult or a SelectionResponse."""
    a, b = getattr(a, "result", a), getattr(b, "result", b)
    ra, rb = result_to_numpy(a), result_to_numpy(b)
    np.testing.assert_array_equal(ra[0], rb[0], err_msg=what)
    np.testing.assert_array_equal(ra[1].view(np.int32), rb[1].view(np.int32), err_msg=what)
    assert ra[2] == rb[2], (what, ra[2], rb[2])
    assert np.float32(ra[3]).view(np.int32) == np.float32(rb[3]).view(np.int32), what


def near_ref(port, jres, tol, what=""):
    """Ids and n_evals equal to a JAX sequential result, gains within ``tol``."""
    order, gains, n_evals, _ = result_to_numpy(getattr(port, "result", port))
    np.testing.assert_array_equal(order, np.asarray(jres.order), err_msg=what)
    assert n_evals == int(jres.n_evals), (what, n_evals, int(jres.n_evals))
    np.testing.assert_allclose(gains, np.asarray(jres.gains), rtol=tol, atol=tol, err_msg=what)


def card_gate(monkeypatch):
    """Make ``backends.choose_backend`` decide as it does on the card (the
    kernel from KERNEL_MIN_N / MF_KERNEL_MIN_N up) for CPU tensors, whose
    kernel wrappers then run their plain versions."""
    from repro_torch.core.optimizers import backends

    def choose(n, budget=None, *, device, matrix_free=False):
        gate = backends.MF_KERNEL_MIN_N if matrix_free else backends.KERNEL_MIN_N
        return "kernel" if n >= gate else "torch"

    monkeypatch.setattr(backends, "choose_backend", choose)


def as_tensor_list(res) -> list:
    return [int(i) for i in torch.as_tensor(res.order).tolist() if i >= 0]
