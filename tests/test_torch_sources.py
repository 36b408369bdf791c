"""The port's similarity sources (repro_torch.core.sources) against the JAX
package's (repro.core.sources), on the CPU: every query of the source
contract per metric, the subset-sweep bit contract, and the memory contract
(no (n, n) allocation in a matrix-free sweep).

Both packages build their sources from the same numpy features; the bars
are the JAX package's own for its matrix-free sources
(tests/test_matrix_free.py:76): 2e-5, and 2e-3 for euclidean, whose
1/(1 + sqrt(d2)) amplifies the cancellation of the duplicate row's d2 ~ 0.
"""
import numpy as np
import pytest
import torch

from repro.core.sources import dense_source as jdense_source
from repro.core.sources import feature_source as jfeature_source
from repro_torch.common import NEG_INF
from repro_torch.core import FacilityLocationMF, create_kernel
from repro_torch.core.optimizers.backends import full_sweep
from repro_torch.core.sources import TILE, dense_source, feature_source

METRICS = ["dot", "cosine", "rbf", "euclidean"]


def _tol(metric):
    return 2e-3 if metric == "euclidean" else 2e-5


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _tricky(rng, n=37, d=8):
    """Non-multiple-of-TILE n, a duplicate row and a zero-norm row (the JAX
    package's tests/test_matrix_free.py:37)."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[5] = x[3]
    x[7] = 0.0
    return x


def _case(kind, seed=0):
    """(x, y or None, labels or None) of a square, rectangular or labelled source."""
    rng = np.random.default_rng(seed)
    if kind == "square":
        return _tricky(rng), None, None
    if kind == "rect":  # u = 45 represented rows, n = 70 candidates, d = 12
        return (rng.normal(size=(45, 12)).astype(np.float32),
                rng.normal(size=(70, 12)).astype(np.float32), None)
    return _tricky(rng), None, rng.integers(0, 3, size=37).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind", ["square", "rect", "labelled"])
@pytest.mark.parametrize("metric", METRICS)
def test_feature_source_contract_matches_jax(kind, metric):
    x, y, labels = _case(kind)
    tol = _tol(metric)
    js = jfeature_source(x, y, metric=metric, labels=labels)
    ps = feature_source(x, y, metric=metric, labels=labels, device="cpu")
    assert (ps.n_rows, ps.n_cols, ps.d) == (js.n_rows, js.n_cols, js.d)
    for name in ("x", "y", "xx", "yy"):
        _close(getattr(ps, name), getattr(js, name), 2e-6)
    n = ps.n_cols
    for j in (0, 3, 5, 7, n - 1):
        _close(ps.col(j), js.col(j), tol)
        _close(ps.col(torch.tensor([j])), js.col(j), tol)  # the engines' one-element form
    _close(ps.col_sums(), js.col_sums(), tol)
    # a state greedy reaches: curmax after two picks (from the JAX side)
    cm = np.maximum(np.asarray(js.col(3)), np.asarray(js.col(11)))
    _close(ps.fl_gains(_t(cm)), js.fl_gains(cm), tol)
    idx = np.array([4, -1, 9, -1, n - 1, 4], np.int32)
    got = ps.fl_gains_at(_t(cm), _t(idx)).numpy()
    want = np.asarray(js.fl_gains_at(cm, idx))
    assert got[1] == NEG_INF and got[3] == NEG_INF
    _close(got[[0, 2, 4, 5]], want[[0, 2, 4, 5]], tol)
    mask = np.zeros(n, bool)
    mask[[2, 5, 7, n - 1]] = True
    _close(ps.masked_rowmax(_t(mask)), js.masked_rowmax(mask), tol)
    _close(ps.masked_rowmax(_t(np.zeros(n, bool))), np.zeros(ps.n_rows), 0.0)
    if y is None:  # square sources: the Graph Cut statistics
        _close(ps.diag(), js.diag(), tol)
        _close(ps.quad(_t(mask)), js.quad(mask), tol)


def test_cosine_zero_row_and_diag():
    """A zero row stays the zero vector under cosine normalisation (norm
    clamped at 1e-12) and its diag is 0.5*(1 + yy) = 0.5, the midpoint it
    has against every row."""
    x, _, _ = _case("square")
    ps = feature_source(x, metric="cosine", device="cpu")
    assert torch.equal(ps.x[7], torch.zeros(8))
    assert float(ps.diag()[7]) == 0.5 and float(ps.diag()[3]) == pytest.approx(1.0, abs=1e-6)
    assert torch.allclose(ps.col(7), torch.full((37,), 0.5))


@pytest.mark.parametrize("sigma", [None, 2.0])
def test_rbf_sigma(sigma):
    """sigma defaults to sqrt(d) of the feature width; an explicit one wins."""
    x, y, _ = _case("rect")
    ps = feature_source(x, y, metric="rbf", rbf_sigma=sigma, device="cpu")
    js = jfeature_source(x, y, metric="rbf", rbf_sigma=sigma)
    _close(ps.col(9), js.col(9), 2e-5)
    s = 12 ** 0.5 if sigma is None else sigma
    d2 = ((x - y[9]) ** 2).sum(1)
    _close(ps.col(9), np.exp(-d2 / (2 * s * s)), 2e-5)


@pytest.mark.parametrize("labelled", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_subset_sweep_is_bit_equal_to_the_full_sweep(metric, labelled):
    """fl_gains_at equals fl_gains bit for bit at the same index, with
    candidates that sit in other column tiles (and at other positions)
    than in the full sweep, and a column equals the sweep's own."""
    rng = np.random.default_rng(5)
    n = 3 * TILE + 77
    x = rng.normal(size=(40, 12)).astype(np.float32)
    y = rng.normal(size=(n, 12)).astype(np.float32)
    kw = {}
    if labelled:
        kw = dict(labels=rng.integers(0, 4, 40), col_labels=rng.integers(0, 4, n))
    ps = feature_source(x, y, metric=metric, device="cpu", **kw)
    cm = torch.from_numpy(rng.uniform(0, 0.5, 40).astype(np.float32))
    full = ps.fl_gains(cm)
    for idx in ([n - 1, 0, -1, 700, 700, 1537], list(range(n))[::-1], [-1, 5]):
        idx = torch.tensor(idx)
        got = ps.fl_gains_at(cm, idx)
        keep = idx >= 0
        assert torch.equal(got[keep], full[idx[keep]])
        assert bool((got[~keep] == NEG_INF).all())
    blocks = {lo: s for lo, _, s in ps._tiles()}
    for j in (0, 17, TILE + 3, n - 1):
        lo = (j // TILE) * TILE
        assert torch.equal(ps.col(j), blocks[lo][:, j - lo])


def test_dense_source_contract_matches_jax():
    x, _, _ = _case("square")
    sim = np.asarray(create_kernel(x, metric="rbf", device="cpu"))
    js, ps = jdense_source(sim), dense_source(sim, device="cpu")
    cm = np.maximum(sim[:, 3], sim[:, 11])
    idx = np.array([4, -1, 36, 4], np.int32)
    mask = np.zeros(37, bool)
    mask[[2, 5, 30]] = True
    for got, want in (
        (ps.col(torch.tensor([9])), js.col(9)),
        (ps.col_sums(), js.col_sums()),
        (ps.diag(), js.diag()),
        (ps.fl_gains(_t(cm)), js.fl_gains(cm)),
        (ps.fl_gains_at(_t(cm), _t(idx)), js.fl_gains_at(cm, idx)),
        (ps.masked_rowmax(_t(mask)), js.masked_rowmax(mask)),
        (ps.quad(_t(mask)), js.quad(mask)),
    ):
        _close(got, want, 2e-5)


def _largest_allocation(fn) -> int:
    """Bytes of the largest single CPU allocation while ``fn`` runs, from
    torch.profiler's memory events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, profile_memory=True) as prof:
        fn()
    sizes = [e.cpu_memory_usage for e in prof.events() if e.cpu_memory_usage > 0]
    assert sizes, "the profiler recorded no allocation"
    return max(sizes)


@pytest.mark.parametrize("kernel", [False, True])
def test_matrix_free_sweep_allocates_no_square_block(kernel):
    """The memory contract: a full FLMF sweep at n = 4096 (u = n) makes no
    single allocation of n*n*4/2 bytes or more, on the torch path and on
    the kernel's plain version; the dense kernel build, measured the same
    way, does (so the check can see such an allocation)."""
    n = 4096
    x = np.random.default_rng(1).normal(size=(n, 8)).astype(np.float32)
    fn = FacilityLocationMF.from_features(x, metric="rbf", use_kernel=kernel, device="cpu")
    state = fn.init_state()
    limit = n * n * 4 // 2
    biggest = _largest_allocation(lambda: full_sweep(fn, state))
    assert n * TILE * 4 <= biggest < limit
    assert _largest_allocation(lambda: create_kernel(x, metric="rbf", device="cpu")) >= n * n * 4
