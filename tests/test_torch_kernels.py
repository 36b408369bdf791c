"""The port's kernel wrappers (repro_torch.kernels.ops) against the JAX
package's Pallas kernels and oracles, on the CPU.  The CUDA kernels are
held against their plain versions on the card by tests/test_torch_gpu.py.

On the CPU the wrappers run the kernels' plain versions; the JAX side runs
its Pallas kernels in interpret mode (repro.kernels.ops picks that by
itself), so shapes stay small."""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.common import NEG_INF
from repro_torch.kernels import ops
from repro_torch.kernels.fl_gains import ROWS_PER_CHUNK, fl_gains_at_plain, fl_gains_plain
from repro_torch.kernels.similarity_kernel import similarity_plain

METRICS = ["dot", "cosine", "euclidean", "rbf"]
SIM_SHAPES = [
    (8, 8, 8),  # far below one tile
    (50, 70, 33),  # ragged, sub-tile
    (130, 257, 600),  # ragged, several JAX tiles and K strips
]
# the JAX package's bars for its own similarity kernels: fp32 dot products
# summed in another order; euclidean / rbf pass through xx + yy - 2<x,y>,
# whose cancellation amplifies that rounding
SIM_TOL = {
    "dot": (1e-4, 1e-3),
    "cosine": (1e-4, 1e-3),
    "euclidean": (1e-3, 5e-2),
    "rbf": (1e-3, 5e-2),
}
# the widths at which the CUDA mainloop's load paths part (16-byte copies
# take fp32 rows with d % 4 == 0 and bf16 rows with d % 8 == 0; a strip is
# 32 k): below, at and across each, with row counts that are not multiples
# of the kernel's 128-row tile
RAGGED_D = [1, 3, 4, 13, 16, 17, 31, 33, 130]
RAGGED_ROWS = (37, 131)
# fp32 sums of at most a few hundred relu terms, in another order than XLA's
FL_TOL = dict(rtol=1e-5, atol=1e-5)
FL_SHAPES = [(8, 8), (40, 60), (300, 700), (513, 257)]
SUBSET_IDX = [
    np.array([0], np.int32),
    np.array([5, 3, 3, 17], np.int32),  # duplicates allowed
    np.array([2, -1, 40, -1, 7, 0], np.int32),  # padded slots
    np.arange(48, dtype=np.int32)[::-1].copy(),  # everything, reversed
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", SIM_SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_similarity_matches_jax(shape, metric):
    n, m, d = shape
    rng = np.random.default_rng(n + m + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(m, d)).astype(np.float32)
    got = ops.similarity(_t(x), _t(y), metric).numpy()
    rtol, atol = SIM_TOL[metric]
    pallas = np.asarray(jops.similarity(x, y, metric=metric))
    np.testing.assert_allclose(got, pallas, rtol=rtol, atol=atol)
    oracle = np.asarray(jops.similarity_ref(x, y, metric))
    np.testing.assert_allclose(got, oracle, rtol=rtol, atol=atol)


@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("metric", METRICS)
def test_similarity_matches_jax_at_ragged_widths(metric, d):
    n, m = RAGGED_ROWS
    rng = np.random.default_rng(1000 + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(m, d)).astype(np.float32)
    got = ops.similarity(_t(x), _t(y), metric).numpy()
    rtol, atol = SIM_TOL[metric]
    np.testing.assert_allclose(got, np.asarray(jops.similarity(x, y, metric=metric)),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, np.asarray(jops.similarity_ref(x, y, metric)),
                               rtol=rtol, atol=atol)


def test_similarity_rbf_sigma_default_is_sqrt_d():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20, 9)).astype(np.float32)
    default = ops.similarity(_t(x), _t(x), "rbf")
    explicit = ops.similarity(_t(x), _t(x), "rbf", rbf_sigma=3.0)
    assert torch.equal(default, explicit)
    want = np.asarray(jops.similarity_ref(x, x, "rbf", rbf_sigma=1.5))
    got = ops.similarity(_t(x), _t(x), "rbf", rbf_sigma=1.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("shape", FL_SHAPES)
def test_fl_gains_matches_jax(shape):
    u, n = shape
    rng = np.random.default_rng(u * n)
    sim = rng.uniform(0, 1, size=(u, n)).astype(np.float32)
    cm = rng.uniform(0, 0.8, size=(u,)).astype(np.float32)
    got = ops.fl_gains(_t(sim), _t(cm)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.fl_gains(sim, cm)), **FL_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.fl_gains_ref(sim, cm)), **FL_TOL)


@pytest.mark.parametrize("idx", SUBSET_IDX)
def test_fl_gains_at_matches_jax_and_full(idx):
    rng = np.random.default_rng(11)
    u, n = 70, 48
    sim = rng.uniform(0, 1, size=(u, n)).astype(np.float32)
    cm = rng.uniform(0, 0.8, size=(u,)).astype(np.float32)
    got = ops.fl_gains_at(_t(sim), _t(cm), _t(idx)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.fl_gains_at(sim, cm, idx)), **FL_TOL)
    full = ops.fl_gains(_t(sim), _t(cm)).numpy()
    mask = idx >= 0
    np.testing.assert_array_equal(got[mask], full[idx[mask]])
    assert (got[~mask] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("u", [1, ROWS_PER_CHUNK - 1, ROWS_PER_CHUNK, 2 * ROWS_PER_CHUNK + 5])
@pytest.mark.parametrize("k", [1, 8, 100, 777])
def test_fl_gains_at_plain_is_bit_equal_to_full(u, k):
    """The gathered sweep adds each column in the full sweep's order, so
    the two are bit-identical at the same index (the kernel's contract,
    held here by the plain versions on the CPU)."""
    rng = np.random.default_rng(u + k)
    n = 777
    sim = _t(rng.uniform(0, 1, size=(u, n)).astype(np.float32))
    cm = _t(rng.uniform(0, 0.8, size=(u,)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, n, size=k), dtype=torch.int32)
    idx[::7] = -1
    got = fl_gains_at_plain(sim, cm, idx)
    full = fl_gains_plain(sim, cm)
    keep = idx >= 0
    assert torch.equal(got[keep], full[idx[keep].long()])
    assert bool((got[~keep] == NEG_INF).all())


def test_wrappers_reject_what_the_kernels_do_not_take():
    s = torch.rand(6, 5)
    cm = torch.rand(6)
    with pytest.raises(TypeError, match="float32"):
        ops.fl_gains(s.double(), cm)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fl_gains(torch.rand(5, 6).T, cm)
    with pytest.raises(ValueError, match="curmax"):
        ops.fl_gains(s, torch.rand(5))
    with pytest.raises(ValueError, match="2-D"):
        ops.similarity(torch.rand(3), torch.rand(3, 1))
    with pytest.raises(ValueError, match="unknown metric"):
        ops.similarity(s, s, "manhattan")
    with pytest.raises(ValueError, match="widths"):
        ops.similarity(torch.rand(3, 4), torch.rand(3, 5))
    with pytest.raises(TypeError, match="idx"):
        ops.fl_gains_at(s, cm, torch.tensor([0.0, 1.0]))
    with pytest.raises(ValueError, match="device"):
        ops.fl_gains(s.to("meta"), cm.to("meta"))


def test_cpu_calls_are_not_kernel_launches():
    before = dict(ops.LAUNCHES)
    s, cm = torch.rand(6, 5), torch.rand(6)
    ops.similarity(s, s)
    ops.fl_gains(s, cm)
    ops.fl_gains_at(s, cm, torch.tensor([0, -1]))
    assert ops.LAUNCHES == before
