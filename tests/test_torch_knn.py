"""The port's sparse k-NN source against the JAX package's, on the CPU.

- ``knn_from_features`` keeps each row's k largest similarities with ties
  to the lower column index (``lax.top_k``'s rule): ids equal to the JAX
  package's, also on duplicated rows where top-k ties;
- the source is the sparsified dense matrix, and its sweeps agree with the
  dense path and with the JAX package's scatter-adds (fp32 sums of a few
  terms in another order: 1e-5);
- ``FacilityLocationMF.from_knn`` / ``GraphCutMF.from_knn`` pick the JAX
  package's ids with its ``n_evals`` through ``solve``, sequential and
  batched (bit-identical to each other);
- a column sum runs in a fixed order: equal bits on every run, and equal
  bits for two columns with the same entries.

Ported from tests/test_matrix_free.py:142-176 and :285-296.
"""
import numpy as np
import pytest
import torch

import repro.core as J
from conftest import make_points
from repro_torch.core import (
    FacilityLocation,
    FacilityLocationMF,
    GraphCut,
    GraphCutMF,
    SelectionSpec,
    create_kernel,
    feature_source,
    knn_from_features,
    knn_source,
    solve,
    sparsify_topk,
)
from repro_torch.core.optimizers.backends import full_sweep
from repro_torch.interop import knn_source_from_arrays, result_to_numpy

CPU = "cpu"
TOL = 1e-5


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _same(a, b):
    ra, rb = result_to_numpy(a), result_to_numpy(b)
    np.testing.assert_array_equal(ra[0], rb[0])
    np.testing.assert_array_equal(ra[1].view(np.int32), rb[1].view(np.int32))
    assert ra[2] == rb[2]


def _near_ref(port, jres, tol=TOL):
    order, gains, n_evals, _ = result_to_numpy(port)
    np.testing.assert_array_equal(order, np.asarray(jres.order))
    assert n_evals == int(jres.n_evals)
    _close(gains, np.asarray(jres.gains), tol)


def _tied_points(rng, n=41, d=8):
    """Duplicated rows (and a repeated pair), so top-k ties at and inside the
    cut."""
    x = make_points(rng, n, d)
    x[5] = x[3]
    x[9] = x[3]
    x[20] = x[11]
    return x


@pytest.mark.parametrize("metric", ["dot", "cosine", "rbf"])
@pytest.mark.parametrize("points", ["plain", "tied"])
def test_knn_from_features_matches_jax_with_ties(metric, points):
    rng = np.random.default_rng(0)
    x = make_points(rng, 41) if points == "plain" else _tied_points(rng)
    src = knn_from_features(x, 6, metric=metric, batch=16, device=CPU)
    jsrc = J.knn_from_features(x, 6, metric=metric, batch=16)
    np.testing.assert_array_equal(src.indices.numpy(), np.asarray(jsrc.indices))
    _close(src.weights, np.asarray(jsrc.weights))
    assert src.indices.dtype == torch.int32 and (src.n_rows, src.n_cols, src.k) == (41, 41, 6)
    # each row: the k largest of its similarity row, descending, ties to the
    # lower column
    fsrc = feature_source(x, metric=metric, device=CPU)
    sim = torch.cat([s[:, :w] for _, w, s in fsrc._tiles()], dim=1)
    for i in range(41):
        row = sim[i]
        want = sorted(range(41), key=lambda j: (-float(row[j]), j))[:6]
        assert src.indices[i].tolist() == want, i


@pytest.mark.parametrize("family", ["fl", "gc"])
@pytest.mark.parametrize("points", ["plain", "tied"])
def test_knn_solve_modes_bit_identical(family, points):
    """tests/test_matrix_free.py:142-156, plus the tied rows: sequential ==
    batched bit for bit, and the JAX package's sequential ids and n_evals."""
    rng = np.random.default_rng(1)
    x = make_points(rng, 41) if points == "plain" else _tied_points(rng)
    src = knn_from_features(x, 6, metric="rbf", device=CPU)
    jsrc = J.knn_from_features(x, 6, metric="rbf")
    if family == "fl":
        fn = FacilityLocationMF.from_knn(src.indices, src.weights)
        jfn = J.FacilityLocationMF.from_knn(jsrc.indices, jsrc.weights)
    else:
        fn = GraphCutMF.from_knn(src.indices, src.weights, lam=0.4)
        jfn = J.GraphCutMF.from_knn(jsrc.indices, jsrc.weights, lam=0.4)
    for optimizer, kw in (("NaiveGreedy", {}), ("LazyGreedy", {"screen_k": 4})):
        spec = SelectionSpec(fn, 4, optimizer, **kw)
        seq = solve(spec)
        for r in solve([spec, spec], mode="batched"):
            _same(seq, r)
        _near_ref(seq, J.solve(J.SelectionSpec(jfn, 4, optimizer, **kw)),
                  1e-4 if family == "gc" else TOL)


def test_knn_source_is_the_sparsified_dense_matrix():
    """tests/test_matrix_free.py:159-176: the source is sparsify_topk of the
    dense kernel, and its sweeps and evaluations are the dense path's."""
    rng = np.random.default_rng(2)
    x = make_points(rng, 29)
    S = sparsify_topk(create_kernel(x, metric="rbf", device=CPU), 5)
    src = knn_from_features(x, 5, metric="rbf", device=CPU)
    _close(src.to_dense(), S)
    jsrc = J.knn_from_features(x, 5, metric="rbf")
    _close(src.to_dense(), np.asarray(jsrc.to_dense()))
    fl_knn = FacilityLocationMF.from_knn(src.indices, src.weights)
    fl_dense = FacilityLocation.from_kernel(src.to_dense())
    st_k, st_d = fl_knn.init_state(), fl_dense.init_state()
    _close(full_sweep(fl_knn, st_k), full_sweep(fl_dense, st_d))
    st_k, st_d = fl_knn.update(st_k, 11), fl_dense.update(st_d, 11)
    _close(full_sweep(fl_knn, st_k), full_sweep(fl_dense, st_d))
    jfl = J.FacilityLocationMF.from_knn(jsrc.indices, jsrc.weights)
    jst = jfl.update(jfl.init_state(), 11)
    _close(full_sweep(fl_knn, st_k), np.asarray(jfl.gains(jst)))
    gc_knn = GraphCutMF.from_knn(src.indices, src.weights, lam=0.3)
    gc_dense = GraphCut.from_kernel(src.to_dense(), lam=0.3)
    _close(full_sweep(gc_knn, gc_knn.init_state()), full_sweep(gc_dense, gc_dense.init_state()))
    mask = torch.zeros(29, dtype=torch.bool)
    mask[[1, 11, 20]] = True
    _close(gc_knn.evaluate(mask), gc_dense.evaluate(mask))
    _close(fl_knn.evaluate(mask), fl_dense.evaluate(mask))
    _close(src.diag(), torch.diagonal(src.to_dense()))
    _close(src.col_sums(), src.to_dense().sum(0))


def test_knn_source_from_arrays_sweeps_match_jax():
    """Pads (-1), ids past n_cols (dropped, as the JAX package's
    mode="drop"), repeated ids in a row and a rectangular source: every
    query of the contract against the JAX package's."""
    rng = np.random.default_rng(3)
    n_rows, n_cols, k = 50, 40, 7
    idx = rng.integers(-1, n_cols + 3, size=(n_rows, k)).astype(np.int32)
    w = rng.random((n_rows, k)).astype(np.float32)
    w[idx < 0] = 0.0
    src = knn_source_from_arrays(idx, w, n_cols=n_cols, device=CPU)
    jsrc = J.knn_source(idx, w, n_cols=n_cols)
    curmax = rng.random(n_rows).astype(np.float32) * 0.5
    cm = torch.from_numpy(curmax)
    _close(src.fl_gains(cm), np.asarray(jsrc.fl_gains(curmax)))
    ids = np.array([3, -1, 39, 0, 17, 17], np.int32)
    _close(src.fl_gains_at(cm, torch.from_numpy(ids)), np.asarray(jsrc.fl_gains_at(curmax, ids)))
    _close(src.col_sums(), np.asarray(jsrc.col_sums()))
    _close(src.diag(), np.asarray(jsrc.diag()))
    _close(src.col(17), np.asarray(jsrc.col(17)))
    mask = rng.random(n_cols) < 0.3
    _close(src.masked_rowmax(torch.from_numpy(mask)), np.asarray(jsrc.masked_rowmax(mask)))
    sq = knn_source_from_arrays(idx[:n_cols, :], w[:n_cols, :], device=CPU)
    jsq = J.knn_source(idx[:n_cols, :], w[:n_cols, :])
    _close(sq.quad(torch.from_numpy(mask)), np.asarray(jsq.quad(mask)), 1e-4)
    _close(src.to_dense(), np.asarray(jsrc.to_dense()))
    with pytest.raises(ValueError, match="indices/weights"):
        knn_source(idx, w[:, :3], device=CPU)


def test_knn_column_sums_run_in_a_fixed_order():
    """Run to run the same bits; a column's bits depend on its own entries
    alone (two columns with the same entries, in rows far apart and among
    columns of every in-degree, sum to the same bits)."""
    rng = np.random.default_rng(4)
    n, k = 3000, 8
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32)
    idx[:, 0] = 7  # a hub: in-degree >= n
    # columns 1 and 2 get the same weights in the same row order
    idx[idx == 1] = 5
    idx[idx == 2] = 5
    rows = np.arange(0, n, 97)
    idx[rows, 1], idx[rows, 2] = 1, 2
    w[rows, 2] = w[rows, 1]
    src = knn_source(idx, w, device=CPU)
    cm = torch.from_numpy(rng.random(n).astype(np.float32) * 0.3)
    a, b = src.fl_gains(cm), src.fl_gains(cm)
    assert torch.equal(a, b)
    assert a[1].item() == a[2].item() and a[1] > 0
    again = knn_source(idx, w, device=CPU).fl_gains(cm)  # a layout built anew
    assert torch.equal(a, again)
    np.testing.assert_allclose(a.numpy(), np.asarray(J.knn_source(idx, w).fl_gains(cm.numpy())),
                               rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("optimizer", ["NaiveGreedy", "LazyGreedy"])
def test_knn_random_neighbours_match_jax(optimizer):
    """The million-point shape of tests/test_matrix_free.py:285-296 at
    n = 4,096 (random neighbours, k = 8): the JAX package's ids and
    n_evals."""
    rng = np.random.default_rng(5)
    n, k = 4096, 8
    indices = rng.integers(0, n, size=(n, k)).astype(np.int32)
    weights = rng.random(size=(n, k)).astype(np.float32)
    fn = FacilityLocationMF.from_knn(indices, weights, n_cols=n, device=CPU)
    jfn = J.FacilityLocationMF.from_knn(indices, weights, n_cols=n)
    res = solve(SelectionSpec(fn, 12, optimizer))
    _near_ref(res, J.solve(J.SelectionSpec(jfn, 12, optimizer)))


@pytest.mark.slow
def test_million_point_fl_knn_source():
    """The sparse k-NN source at n = 10^6: O(n * k) sweeps, no similarity
    matrix (tests/test_matrix_free.py:285-296)."""
    rng = np.random.default_rng(0)
    n, k = 1_000_000, 8
    indices = rng.integers(0, n, size=(n, k)).astype(np.int32)
    weights = rng.random(size=(n, k)).astype(np.float32)
    fn = FacilityLocationMF.from_knn(indices, weights, n_cols=n, device=CPU)
    res = solve(SelectionSpec(fn, 4))
    order = [i for i in res.order.tolist() if i >= 0]
    assert len(order) == 4 and len(set(order)) == 4
