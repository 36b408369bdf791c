"""The port's kernel wrappers (repro_torch.kernels.ops) against the JAX
package's Pallas kernels and oracles, on the CPU.  The CUDA kernels are
held against their plain versions on the card by tests/test_torch_gpu.py.

On the CPU the wrappers run the kernels' plain versions; the JAX side runs
its Pallas kernels in interpret mode (repro.kernels.ops picks that by
itself), so shapes stay small."""
import math

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.common import NEG_INF
from repro_torch.kernels import _build, fl_gains, ops
from repro_torch.kernels.fl_gains import (
    CLUSTER,
    CLUSTERS,
    FULL_SWEEP_RATIO,
    MAX_THREADS,
    ROWS_PER_CHUNK,
    fl_gains_at_plain,
    fl_gains_plain,
    sweep_layout,
    sweeps_every_column,
)
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


@pytest.mark.parametrize("idx", SUBSET_IDX)
def test_fl_gains_at_takes_int32_and_int64_ids(idx):
    """The engine hands int64 ids over, other callers int32: the wrapper
    takes both as they are, with equal results."""
    rng = np.random.default_rng(12)
    sim = _t(rng.uniform(0, 1, size=(70, 48)).astype(np.float32))
    cm = _t(rng.uniform(0, 0.8, size=(70,)).astype(np.float32))
    got32 = ops.fl_gains_at(sim, cm, _t(idx))
    got64 = ops.fl_gains_at(sim, cm, _t(idx.astype(np.int64)))
    assert got32.dtype == got64.dtype == torch.float32
    assert torch.equal(got32, got64)


# -- a bf16 S: widened as it is read, summed in fp32 in the fp32 order ---------


@pytest.mark.parametrize("members", [None, 3])
@pytest.mark.parametrize("u,n", [(1, 5), (127, 40), (300, 257)])
def test_fl_bf16_sweeps_equal_the_fp32_sweep_of_the_widened_values(u, n, members):
    """A bf16 S sweeps to the bits of the fp32 sweep of ``S.float()``, single
    and as a wave; its gathered sweep (int32 and int64 ids, both sides of
    the crossover) equals its full sweep at the same index."""
    rng = np.random.default_rng(u * n + (members or 0))
    lead = () if members is None else (members,)
    sim = _t(rng.uniform(0, 1, size=lead + (u, n)).astype(np.float32)).bfloat16()
    cm = _t(rng.uniform(0, 0.8, size=lead + (u,)).astype(np.float32))
    full = ops.fl_gains(sim, cm)
    assert full.dtype == torch.float32
    assert torch.equal(full, ops.fl_gains(sim.float(), cm))
    for k in (1, max(1, int(FULL_SWEEP_RATIO * n) - 1), n):
        idx = torch.as_tensor(rng.integers(-1, n, size=lead + (k,)))
        for dtype in (torch.int32, torch.int64):
            got = ops.fl_gains_at(sim, cm, idx.to(dtype))
            assert torch.equal(got, ops.fl_gains_at(sim.float(), cm, idx))
            want = torch.where(idx < 0, NEG_INF, full.gather(-1, idx.clamp(min=0)))
            assert torch.equal(got, want), (k, dtype)


@pytest.mark.parametrize("shape", FL_SHAPES[1:3])
def test_fl_bf16_sweeps_match_jax(shape):
    """The TPU kernel's own bf16 contract: a bf16 S widened in the body."""
    import jax.numpy as jnp

    u, n = shape
    rng = np.random.default_rng(u + n)
    sim = rng.uniform(0, 1, size=(u, n)).astype(np.float32)
    cm = rng.uniform(0, 0.8, size=(u,)).astype(np.float32)
    s16 = _t(sim).bfloat16()
    j16 = jnp.asarray(sim, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(j16.astype(jnp.float32)), s16.float().numpy())
    np.testing.assert_allclose(ops.fl_gains(s16, _t(cm)).numpy(),
                               np.asarray(jops.fl_gains(j16, cm)), **FL_TOL)
    idx = np.array([0, n - 1, -1, n // 2], np.int32)
    np.testing.assert_allclose(ops.fl_gains_at(s16, _t(cm), _t(idx)).numpy(),
                               np.asarray(jops.fl_gains_at(j16, cm, idx)), **FL_TOL)


def test_bf16_launches_pass_the_element_size(monkeypatch):
    """A bf16 sweep goes to the wave entry (with one member when single)
    with its element size, 2; an fp32 single sweep keeps its own entry (a
    stand-in library records the calls; no kernel runs here)."""
    calls = []

    class Lib:
        def fl_gains_launch(self, *args):
            calls.append(("single", args))
            return 0

        def fl_gains_wave_launch(self, *args):
            calls.append(("wave", args))
            return 0

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(_build, "raw_stream", lambda t: 0)
    sim, cm = torch.zeros((130, 100)), torch.zeros(130)
    ids = torch.tensor([0, 5, -1])
    for s, c, idx, entry, size in ((sim, cm, None, "single", None),
                                   (sim.bfloat16(), cm, None, "wave", 2),
                                   (sim.bfloat16(), cm, ids, "wave", 2),
                                   (sim[None], cm[None], None, "wave", 4),
                                   (sim[None].bfloat16(), cm[None], ids[None], "wave", 2)):
        fl_gains._launch(s, c, idx)
        got, args = calls[-1]
        assert got == entry
        if entry == "wave":
            # the stride between members, the row stride, u, n, the members, the size
            assert args[2:6] == (100, 130, 100, 1) and args[-1] == size
            assert args[1] == (0 if s.dim() == 2 else s.stride(0))


@pytest.mark.parametrize("n", [1, 7, 18, 100, 4096, 50_000, 1 << 20])
def test_crossover_rule_at_its_edges(n):
    """A pure function of (k, n): from ceil(FULL_SWEEP_RATIO * n) columns
    up the gathered sweep runs as the full sweep and a gather."""
    edge = math.ceil(FULL_SWEEP_RATIO * n)
    assert sweeps_every_column(edge, n)
    assert sweeps_every_column(edge + 1, n)
    assert not sweeps_every_column(edge - 1, n)
    assert not sweeps_every_column(0, n) or edge == 0
    assert sweeps_every_column(n, n) and sweeps_every_column(n + 3, n)
    assert [sweeps_every_column(k, n) for k in range(max(0, edge - 3), edge + 3)] == sorted(
        sweeps_every_column(k, n) for k in range(max(0, edge - 3), edge + 3))


FIRST_LIMIT = 65_535 * ROWS_PER_CHUNK  # the first design's grid.y cap: 8,388,480 rows


@pytest.mark.parametrize("u", [1, 127, 128, 129, 50_000, FIRST_LIMIT, FIRST_LIMIT + 1,
                               1 << 24, (1 << 31) + 5])
@pytest.mark.parametrize("k", [1, 8, 64, 200, 512, 2048, 50_000, 1 << 20])
def test_sweep_layout_covers_every_chunk_past_the_old_row_limit(u, k):
    """The gathered launch's layout is arithmetic on (u, k): every column
    has its cluster, every chunk its window and slot, the grid runs along x
    alone and stays under CUDA's limits, whatever u, past the first design's
    8,388,480 rows."""
    g, slots, threads, blocks, windows = sweep_layout(u, k)
    nchunks = -(-u // ROWS_PER_CHUNK)
    assert g == min(MAX_THREADS, -(-k // CLUSTERS))  # few enough clusters to run at once
    assert 1 <= slots and g * slots <= threads <= MAX_THREADS and threads % 32 == 0
    assert threads < g * slots + 32  # no whole idle warp
    # as many slots as a block's threads hold, no more than the chunks need
    assert slots == min(-(-nchunks // CLUSTER), MAX_THREADS // g)
    clusters = blocks // CLUSTER
    assert blocks % CLUSTER == 0 and clusters * g >= k > (clusters - 1) * g
    assert blocks <= 2**31 - 1
    window = CLUSTER * slots
    assert windows * window >= nchunks > (windows - 1) * window


def test_launcher_passes_rows_past_the_old_limit(monkeypatch):
    """The Python launcher no longer refuses u > 8,388,480 rows: it hands
    the kernel the gathered sweep's layout, or the full sweep's scratch
    (for the full sweep and past the crossover), and the ids' width (int32
    or int64) as they are (a stand-in library records the call; no kernel
    runs here)."""
    calls = []

    class Lib:
        def fl_gains_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(_build, "raw_stream", lambda t: 0)
    u, n = FIRST_LIMIT + 1, 100
    # stride-0 views: the shapes of the launch, without its memory
    sim, cm = torch.zeros((1, n)).expand(u, n), torch.zeros((1,)).expand(u)
    for idx, width in ((None, 0), (torch.tensor([0, -1, 9]), 8),
                       (torch.tensor([3], dtype=torch.int32), 4), (torch.arange(n), 8)):
        k = n if idx is None else idx.shape[0]
        assert fl_gains._launch(sim, cm, idx).shape == (k,)
        args = calls[-1]
        assert args[2:4] == (u, n) and args[6:9] == (width, k, ROWS_PER_CHUNK)
        sweep = idx is None or sweeps_every_column(k, n)
        assert sweep == (k == n)
        assert args[9:12] == ((0, 0, 0) if sweep else sweep_layout(u, k)[:3])
        assert (args[12] is not None) == sweep  # the full sweep's partial sums
        assert (args[13] is not None) == (sweep and idx is not None)  # the n-long scratch


# -- waves: B members of one shape in one call (the batched engine's) ---------


def _wave(B, u, n, seed, pad_rows=0):
    """A (B, u + pad_rows, n) stack of members with their curmax, each member
    on its own 512-byte slab as the batched engine stacks them; the padded
    rows hold S = 0 and curmax = 0."""
    rng = np.random.default_rng(seed)
    rows = u + pad_rows
    stride = -(-rows * n // 128) * 128
    sim = torch.zeros(B * stride).as_strided((B, rows, n), (stride, n, 1))
    sim[:, :u] = torch.from_numpy(rng.random((B, u, n), dtype=np.float32))
    cm = torch.zeros((B, rows))
    cm[:, :u] = torch.from_numpy(rng.random((B, u), dtype=np.float32) * 0.6)
    return sim, cm


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("u,n", [(131, 40), (300, 257), (128, 9)])
def test_fl_wave_equals_each_member_call_bit_for_bit(B, u, n):
    """A wave's row b is member b's own call, bit for bit: the full sweep,
    and gathered sweeps on both sides of the crossover (k < and >= 0.05 n),
    with int32 and int64 ids (u not a multiple of the 128-row chunk)."""
    sim, cm = _wave(B, u, n, seed=B * 1000 + u)
    full = ops.fl_gains(sim, cm)
    assert full.shape == (B, n)
    for b in range(B):
        assert torch.equal(full[b], ops.fl_gains(sim[b].contiguous(), cm[b].clone()))
    rng = np.random.default_rng(u)
    narrow = max(1, int(FULL_SWEEP_RATIO * n) - 1)
    for k in sorted({1, narrow, math.ceil(FULL_SWEEP_RATIO * n), n + 3}):
        ids = torch.from_numpy(rng.integers(-1, n, size=(B, k)))
        for dtype in (torch.int32, torch.int64):
            got = ops.fl_gains_at(sim, cm, ids.to(dtype))
            assert got.shape == (B, k)
            for b in range(B):
                one = ops.fl_gains_at(sim[b].contiguous(), cm[b].clone(), ids[b].to(dtype))
                assert torch.equal(got[b], one), (b, k, dtype)
                want = torch.where(ids[b] < 0, NEG_INF, full[b][ids[b].clamp(min=0)])
                assert torch.equal(got[b], want)


def test_fl_wave_of_zero_padded_members_equals_the_unpadded_call():
    """Zero-padded rows (S = 0, curmax = 0) add +0.0: a member padded to a
    longer u, and to more columns, sweeps to the unpadded member's bits."""
    u, n, pad = 200, 60, 70
    sim, cm = _wave(3, u, n, seed=7, pad_rows=pad)
    wide = torch.zeros((3, u + pad, n + 5))
    wide[:, :, :n] = sim
    full = ops.fl_gains(wide, cm)
    ids = torch.tensor([[0, 59, -1, 3], [1, 1, 2, 58], [7, 64, 0, -1]])
    part = ops.fl_gains_at(wide, cm, ids)
    for b in range(3):
        own = ops.fl_gains(sim[b, :u].contiguous(), cm[b, :u].clone())
        assert torch.equal(full[b, :n], own)
        assert torch.equal(full[b, n:], torch.zeros(5))
        live = (ids[b] >= 0) & (ids[b] < n)
        assert torch.equal(part[b][live], own[ids[b][live]])


def test_fl_wave_wrappers_check_the_member_layout():
    sim, cm = _wave(2, 10, 6, seed=1)
    with pytest.raises(ValueError, match="curmax"):
        ops.fl_gains(sim, cm[:, :9])
    with pytest.raises(ValueError, match="contiguous"):
        ops.fl_gains(sim.transpose(1, 2), cm)
    with pytest.raises(ValueError, match="at least one member"):
        ops.fl_gains(sim[:0], cm[:0])
    with pytest.raises(ValueError, match="idx"):
        ops.fl_gains_at(sim, cm, torch.zeros((3, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="2-D"):
        ops.fl_gains_at(sim, cm, torch.zeros(2, dtype=torch.int64))


def test_wave_launcher_passes_member_strides(monkeypatch):
    """The wave launcher hands the kernel each tensor's member stride (a
    stand-in library records the call; no kernel runs here)."""
    calls = []

    class Lib:
        def fl_gains_wave_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(_build, "raw_stream", lambda t: 0)
    sim, cm = _wave(3, 130, 100, seed=2)
    ids = torch.zeros((3, 90), dtype=torch.int64)[:, 10:14]  # rows of a wider sort
    for idx, k in ((None, 100), (ids, 4)):
        assert fl_gains._launch(sim, cm, idx).shape == (3, k)
        args = calls[-1]
        assert args[1:6] == (sim.stride(0), 100, 130, 100, 3) and args[7] == 130
        assert args[10:12] == ((0, k) if idx is None else (90, k))
        assert (args[16] is not None) == (idx is None)  # the full sweep's partial sums


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
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fl_gains(s.half(), cm)
    with pytest.raises(TypeError, match="curmax must be float32"):
        ops.fl_gains(s.bfloat16(), cm.bfloat16())
    with pytest.raises(ValueError, match="device"):
        ops.fl_gains(s.to("meta"), cm)
    # the other wrappers take no meta tensor: only the FL sweeps are operators
    with pytest.raises(ValueError, match="device"):
        ops.similarity(s.to("meta"), s.to("meta"))


def test_cpu_calls_are_not_kernel_launches():
    before = dict(ops.LAUNCHES)
    s, cm = torch.rand(6, 5), torch.rand(6)
    ops.similarity(s, s)
    ops.fl_gains(s, cm)
    ops.fl_gains_at(s, cm, torch.tensor([0, -1]))
    ops.fl_gains_at(s, cm, torch.tensor([0, -1], dtype=torch.int32))
    assert ops.LAUNCHES == before
