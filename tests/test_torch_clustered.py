"""The port's clustered mode against the JAX package on the CPU: ``kmeans``,
``cluster_mask``, ``clustered`` FacilityLocation / GraphCut selections (the
dense FL and GC kernels' plain versions under ``use_kernel=True``), the §8
per-cluster-sum identity, ``clustered_matrix_free`` and
``build_extended_kernel``.

Inputs are numpy arrays from a seed, handed to both packages; the
selections take the JAX ``kmeans`` labels as numpy.  torch's random numbers
are not ``jax.random``'s, so ``kmeans``' own draw is held to the partition
it finds on a well-separated mixture (up to relabelling), and its Lloyd
iteration to the JAX labels exactly when both start from the JAX package's
initial rows.  Bars: ids and n_evals equal; FL gains to 1e-5 and GC gains to
1e-4 (the JAX package's bars for its fl / gc kernels, tests/test_kernels.py);
evaluations to 1e-5 (tests/test_clustered.py); the extended kernel to 1e-6
(fp32 similarities formed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro_torch.core import (
    FacilityLocation,
    FacilityLocationMF,
    GraphCut,
    GraphCutMF,
    SelectionSpec,
    backend_name,
    build_extended_kernel,
    cluster_mask,
    clustered,
    clustered_matrix_free,
    create_kernel,
    kmeans,
    solve,
)
from repro_torch.core.optimizers.backends import full_sweep
from repro_torch.interop import result_to_numpy

N, D, K, BUDGET = 60, 8, 4, 10
FL_TOL = dict(rtol=1e-5, atol=1e-5)
GC_TOL = dict(rtol=1e-4, atol=1e-4)
OPTIMIZERS = [("NaiveGreedy", {}), ("LazyGreedy", {"screen_k": 8})]
_JAX: dict = {}


def _points(seed=0, n=N):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _setup():
    """Features, their rbf kernel and the JAX package's kmeans labels."""
    if "setup" not in _JAX:
        x = _points()
        labels = np.asarray(J.kmeans(jnp.asarray(x), K)).astype(np.int32)
        S = np.asarray(J.create_kernel(x, metric="rbf"))
        _JAX["setup"] = (x, labels, S)
    return _JAX["setup"]


def _blobs(seed, per=25, sep=40.0):
    """Two blobs far apart: Lloyd's iteration recovers them from any start."""
    rng = np.random.default_rng(seed)
    truth = np.repeat([0, 1], per)
    x = rng.normal(size=(2 * per, D)).astype(np.float32)
    x[truth == 1, 0] += sep
    return x, truth


def _same_partition(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return bool(((a[:, None] == a[None, :]) == (b[:, None] == b[None, :])).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_finds_the_partition_like_jax(seed):
    x, truth = _blobs(seed)
    gen = torch.Generator().manual_seed(seed)
    port = kmeans(torch.from_numpy(x), 2, generator=gen)
    assert port.dtype == torch.int64 and port.shape == (x.shape[0],)
    jlab = np.asarray(J.kmeans(jnp.asarray(x), 2, key=jax.random.PRNGKey(seed)))
    assert _same_partition(port.numpy(), truth)
    assert _same_partition(jlab, truth)


@pytest.mark.parametrize("k,iters", [(4, 25), (7, 3), (60, 2)])
def test_kmeans_iteration_equals_jax_from_the_same_start(k, iters, monkeypatch):
    """Handed the JAX package's initial rows (jax.random.choice of
    PRNGKey(0)) through its draw, the port's Lloyd steps give the JAX
    labels exactly; k = n exercises empty clusters."""
    x = _points(1)
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(0), N, (k,), replace=False))
    perm = torch.from_numpy(np.concatenate([init, np.setdiff1d(np.arange(N), init)]))
    monkeypatch.setattr(torch, "randperm", lambda n, generator=None, device=None: perm)
    want = np.asarray(J.kmeans(jnp.asarray(x), k, iters=iters))
    got = kmeans(torch.from_numpy(x), k, iters=iters)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kmeans_default_draw_is_seeded():
    x = torch.from_numpy(_points(2))
    assert torch.equal(kmeans(x, 5), kmeans(x, 5))
    assert torch.equal(kmeans(x, 5), kmeans(x, 5, generator=torch.Generator().manual_seed(0)))


def test_cluster_mask_matches_jax():
    labels = np.asarray([0, 1, 0, 2, 1, 2, 2], np.int32)
    got = cluster_mask(labels)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.cluster_mask(labels)))
    np.testing.assert_array_equal(cluster_mask(torch.from_numpy(labels)).numpy(), got.numpy())


def test_create_kernel_points_at_clustered_mode():
    with pytest.raises(ValueError, match="clustered.py"):
        create_kernel(_points(), mode="clustered", device="cpu")


def _jax_clustered(family, use_kernel):
    key = ("fn", family, use_kernel)
    if key not in _JAX:
        _, labels, S = _setup()
        if family == "fl":
            _JAX[key] = J.clustered(J.FacilityLocation.from_kernel, S, labels, use_kernel=use_kernel)
        else:
            _JAX[key] = J.clustered(J.GraphCut.from_kernel, S, labels, lam=0.4,
                                    use_kernel=use_kernel)
    return _JAX[key]


def _port_clustered(family, use_kernel):
    _, labels, S = _setup()
    if family == "fl":
        return clustered(FacilityLocation.from_kernel, S, labels, use_kernel=use_kernel,
                         device="cpu")
    return clustered(GraphCut.from_kernel, S, labels, lam=0.4, use_kernel=use_kernel, device="cpu")


@pytest.mark.parametrize("family", ["fl", "gc"])
def test_clustered_kernel_equals_jax_masked_kernel(family):
    port, jfn = _port_clustered(family, False), _jax_clustered(family, False)
    want = np.asarray(jfn.sim if family == "fl" else jfn.sim_ground)
    got = port.sim if family == "fl" else port.sim_ground
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("family", ["fl", "gc"])
@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_clustered_selection_matches_jax(optimizer, params, family, use_kernel):
    """Dense clustered FL / GC through solve(): the JAX package's ids and
    n_evals; use_kernel=True runs the fl / gc kernels' plain versions here
    and the Pallas kernels (interpret mode) on the JAX side."""
    fn = _port_clustered(family, use_kernel)
    want_backend = {"fl": "cuda-fl", "gc": "cuda-gc"}[family] if use_kernel else "torch"
    assert backend_name(fn) == want_backend
    key = ("res", family, use_kernel, optimizer)
    if key not in _JAX:
        r = J.solve(J.SelectionSpec(_jax_clustered(family, use_kernel), BUDGET, optimizer, **params))
        _JAX[key] = (np.asarray(r.order), np.asarray(r.gains), int(r.n_evals))
    order, gains, n_evals = _JAX[key]
    got = result_to_numpy(solve(SelectionSpec(fn, BUDGET, optimizer, **params)))
    np.testing.assert_array_equal(got[0], order)
    assert got[2] == n_evals
    np.testing.assert_allclose(got[1], gains, **(FL_TOL if family == "fl" else GC_TOL))


def _per_cluster_sum(make, S, labels, mask, **kw):
    """sum_l f_{C_l}(A ∩ C_l), each cluster's function built on its own."""
    total = 0.0
    for c in np.unique(labels):
        sel = labels == c
        fn = make(torch.from_numpy(np.ascontiguousarray(S[np.ix_(sel, sel)])), **kw)
        total += float(fn.evaluate(torch.from_numpy(mask[sel])))
    return total


@pytest.mark.parametrize("family", ["fl", "gc"])
def test_clustered_equals_per_cluster_sum(family):
    _, labels, S = _setup()
    mask = np.zeros(N, bool)
    mask[np.random.default_rng(3).choice(N, size=15, replace=False)] = True
    make, kw = ((FacilityLocation.from_kernel, {}) if family == "fl"
                else (GraphCut.from_kernel, {"lam": 0.4}))
    fn = clustered(make, S, labels, device="cpu", **kw)
    want = _per_cluster_sum(make, S, labels, mask, **kw)
    np.testing.assert_allclose(float(fn.evaluate(torch.from_numpy(mask))), want, **FL_TOL)
    jfn = _jax_clustered(family, False)
    np.testing.assert_allclose(float(fn.evaluate(torch.from_numpy(mask))),
                               float(jfn.evaluate(jnp.asarray(mask))), **FL_TOL)


@pytest.mark.parametrize("family", ["fl", "gc"])
def test_clustered_matrix_free_matches_dense_and_jax(family):
    """The labelled FeatureSource zeroes cross-cluster similarity in-stream:
    its sweep equals the dense clustered sweep (the JAX package's bar for
    this, tests/test_clustered.py:75, 2e-5), and NaiveGreedy picks the JAX
    package's matrix-free clustered ids."""
    x, labels, S = _setup()
    if family == "fl":
        mf = clustered_matrix_free(FacilityLocationMF.from_features, x, labels, metric="rbf",
                                   device="cpu")
        dense = clustered(FacilityLocation.from_kernel, S, labels, device="cpu")
        jmf = J.clustered_matrix_free(J.FacilityLocationMF.from_features, x, labels, metric="rbf")
    else:
        mf = clustered_matrix_free(GraphCutMF.from_features, x, labels, metric="rbf", lam=0.4,
                                   device="cpu")
        dense = clustered(GraphCut.from_kernel, S, labels, lam=0.4, device="cpu")
        jmf = J.clustered_matrix_free(J.GraphCutMF.from_features, x, labels, metric="rbf",
                                      lam=0.4)
    assert backend_name(mf) == "torch"
    np.testing.assert_allclose(full_sweep(mf, mf.init_state()).numpy(),
                               full_sweep(dense, dense.init_state()).numpy(),
                               rtol=2e-5, atol=2e-5)
    jr = J.solve(J.SelectionSpec(jmf, BUDGET))
    got = result_to_numpy(solve(SelectionSpec(mf, BUDGET)))
    np.testing.assert_array_equal(got[0], np.asarray(jr.order))
    assert got[2] == int(jr.n_evals)
    np.testing.assert_allclose(got[1], np.asarray(jr.gains), rtol=2e-5, atol=2e-5)


EXTENDED = [
    dict(query=True, private=False, eta=1.0, nu=1.0),
    dict(query=False, private=True, eta=1.0, nu=0.5),
    dict(query=True, private=True, eta=0.25, nu=2.0),
    dict(query=True, private=True, eta=-1.0, nu=1.0),
]


@pytest.mark.parametrize("case", EXTENDED, ids=["q", "p", "qp-scaled", "negative-eta"])
@pytest.mark.parametrize("metric", ["cosine", "rbf"])
def test_build_extended_kernel_matches_jax(case, metric):
    rng = np.random.default_rng(7)
    V, Q, P = (rng.normal(size=(m, 5)).astype(np.float32) for m in (12, 4, 3))
    q = Q if case["query"] else None
    p = P if case["private"] else None
    S, q_idx, p_idx = build_extended_kernel(V, q, p, metric=metric, eta=case["eta"],
                                            nu=case["nu"], device="cpu")
    jS, jq, jp = J.build_extended_kernel(V, q, p, metric=metric, eta=case["eta"], nu=case["nu"])
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(q_idx.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(jp))
