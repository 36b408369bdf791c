"""On the card: each CUDA kernel of the port against its plain PyTorch
version, and the main path on the card against the CPU.  Every test here is
marked ``gpu`` and skips where there is no CUDA device (decided in the
``cuda`` fixture).  This file imports torch and the port only, so it also
runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.common import NEG_INF
from repro_torch.core import (
    DisparityMin,
    DisparitySum,
    FacilityLocation,
    FacilityLocationMF,
    FeatureBased,
    GraphCutMF,
    ProbabilisticSetCover,
    SelectionSpec,
    SetCover,
    backend_name,
    feature_source,
    solve,
)
from repro_torch.core.optimizers.backends import KERNEL_MIN_N
from repro_torch.interop import (
    facility_location_from_arrays,
    graph_cut_from_arrays,
    result_to_numpy,
)
from repro_torch.kernels import fl_gains as fl_module
from repro_torch.kernels import ops
from repro_torch.kernels.disp_gains import dmin_gains_plain, dsum_gains_plain
from repro_torch.kernels.fb_gains import fb_gains_at_plain, fb_gains_plain
from repro_torch.kernels.fl_gains import fl_gains_at_plain, fl_gains_plain
from repro_torch.kernels.gc_gains import gc_gains_at_plain, gc_gains_plain
from repro_torch.kernels import flmf_gains as flmf_module
from repro_torch.kernels.flmf_gains import SCRATCH_BYTES, flmf_gains_at_plain, flmf_gains_plain
from repro_torch.kernels.fused_fl_sweep import fused_fl_sweep_plain
from repro_torch.kernels.gcmf_gains import gcmf_gains_at_plain, gcmf_gains_plain
from repro_torch.kernels.row_reduce import SEL_CHUNK
from repro_torch.kernels.sc_gains import psc_gains_plain, sc_gains_plain
from repro_torch.kernels.select_cols import select_cols
from repro_torch.kernels.similarity_kernel import (
    _normalize,
    inv_two_sigma_sq,
    launch_rows,
    similarity_plain,
)

pytestmark = pytest.mark.gpu

METRICS = ["dot", "cosine", "euclidean", "rbf"]
# the JAX package's bars for its similarity kernels: fp32 dot products
# summed in another order; euclidean / rbf pass through xx + yy - 2<x,y>
SIM_TOL = {
    "dot": (1e-4, 1e-3),
    "cosine": (1e-4, 1e-3),
    "euclidean": (1e-3, 5e-2),
    "rbf": (1e-3, 5e-2),
}
# flmf / gcmf kernel vs plain: fp32 sums over similarities that the kernel's
# fmaf chain and the plain version's matmul may round differently; euclidean
# takes the JAX package's matrix-free bar (tests/test_matrix_free.py:76), as
# a self pair's d2 ~ 0 comes out of cancellation and 1 / (1 + sqrt(d2))
# amplifies its rounding
MF_TOL = {m: dict(rtol=2e-5, atol=1e-4) for m in ("dot", "cosine", "rbf")}
MF_TOL["euclidean"] = dict(rtol=2e-5, atol=2e-3)
MF_SHAPES = [(1000, 777, 130), (300, 1500, 512), (129, 1, 8), (1, 300, 13)]
OPTIMIZERS = [
    ("NaiveGreedy", {}),
    ("LazyGreedy", {"screen_k": 1}),
    ("LazyGreedy", {"screen_k": 8}),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1000, 777, 130), (256, 384, 512), (1, 3, 1)])
@pytest.mark.parametrize("metric", METRICS)
def test_similarity_kernel_matches_plain(cuda, shape, metric):
    n, m, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n, d), generator=g, device=cuda)
    y = torch.randn((m, d), generator=g, device=cuda)
    before = ops.LAUNCHES["similarity"]
    got = ops.similarity(x, y, metric)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["similarity"] == before + 1
    rtol, atol = SIM_TOL[metric]
    torch.testing.assert_close(got, similarity_plain(x, y, metric), rtol=rtol, atol=atol)


# rows that no 16-byte copy can take (csrc/sgemm_pipe.cuh's element-wise
# path: 4-byte copies for fp32, element loads for bf16): widths below one
# 32-k strip, not a multiple of it and a multiple of it; row counts below
# one 128-row tile and not multiples of 4, and a shape of several tiles
UNALIGNED_D = [1, 13, 72, 130, 512]
UNALIGNED_SHAPES = [(37, 101), (300, 1001)]


def _offset_rows(t):
    """A copy of the 2-D tensor ``t`` one element into a flat buffer, a
    contiguous view whose base (and so every row) is not 16-byte aligned."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16
    return view


@pytest.mark.parametrize("shape", UNALIGNED_SHAPES)
@pytest.mark.parametrize("d", UNALIGNED_D)
@pytest.mark.parametrize("metric", METRICS)
def test_similarity_kernel_on_unaligned_rows(cuda, metric, d, shape):
    """Unaligned rows take the 4-byte copy path and give the kernel's bits on
    aligned rows (the 16-byte path where d % 4 == 0).  The bits are
    held where the kernel gets the rows: ``ops.similarity`` normalises cosine
    rows into new tensors first, with a torch norm whose order may depend on
    the rows' alignment, so cosine is held on pre-normalised rows."""
    n, m = shape
    g = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((n, d), generator=g, device=cuda)
    y = torch.randn((m, d), generator=g, device=cuda)
    before = ops.LAUNCHES["similarity"]
    got = ops.similarity(_offset_rows(x), _offset_rows(y), metric)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["similarity"] == before + 1
    rtol, atol = SIM_TOL[metric]
    torch.testing.assert_close(got, similarity_plain(x, y, metric), rtol=rtol, atol=atol)
    if metric == "dot":
        assert torch.equal(got, ops.similarity(x, y, metric))
    if metric == "cosine":
        x, y = _normalize(x), _normalize(y)
    inv2s2 = inv_two_sigma_sq(d, None)
    want = launch_rows(x, y, metric, inv2s2)
    assert torch.equal(launch_rows(_offset_rows(x), _offset_rows(y), metric, inv2s2), want)
    assert torch.equal(launch_rows(x, _offset_rows(y), metric, inv2s2), want)


@pytest.mark.parametrize("shape", [(4096, 4096), (1000, 777), (333, 5000), (129, 1)])
def test_fl_gains_kernels_match_plain(cuda, shape):
    """Kernel and plain version add in the same order: equal bit for bit,
    and the gathered kernel equals the full kernel at the same index."""
    u, n = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    sim = torch.rand((u, n), generator=g, device=cuda)
    cm = 0.8 * torch.rand((u,), generator=g, device=cuda)
    before = dict(ops.LAUNCHES)
    full = ops.fl_gains(sim, cm)
    torch.cuda.synchronize()
    assert torch.equal(full, fl_gains_plain(sim, cm))
    for k in (1, 8, 100, 777):
        idx = torch.randint(0, n, (k,), generator=g, device=cuda)
        idx[::7] = -1
        got = ops.fl_gains_at(sim, cm, idx)
        torch.cuda.synchronize()
        keep = idx >= 0
        assert torch.equal(got[keep], full[idx[keep]])
        assert bool((got[~keep] == NEG_INF).all())
        assert torch.equal(got, fl_gains_at_plain(sim, cm, idx))
    assert ops.LAUNCHES["fl_gains"] == before["fl_gains"] + 1
    assert ops.LAUNCHES["fl_gains_at"] == before["fl_gains_at"] + 4


@pytest.mark.parametrize("members", [None, 3])
@pytest.mark.parametrize("shape", [(4096, 4096), (1000, 777), (333, 5000), (129, 1)])
def test_fl_bf16_kernels_are_the_fp32_kernels_on_the_widened_s(cuda, shape, members):
    """A bf16 S is widened as it is read: the full and gathered kernels,
    single and as a wave, equal the fp32 kernels on ``S.float()`` and the
    plain versions bit for bit, with int32 and int64 ids."""
    u, n = shape
    lead = () if members is None else (members,)
    g = torch.Generator(device=cuda).manual_seed(2)
    sim = torch.rand(lead + (u, n), generator=g, device=cuda).bfloat16()
    cm = 0.8 * torch.rand(lead + (u,), generator=g, device=cuda)
    full = ops.fl_gains(sim, cm)
    assert torch.equal(full, ops.fl_gains(sim.float(), cm))
    assert torch.equal(full, fl_gains_plain(sim, cm))
    for k in (1, 8, 100, 777):
        idx = torch.randint(-1, n, lead + (k,), generator=g, device=cuda)
        got = ops.fl_gains_at(sim, cm, idx)
        assert torch.equal(got, ops.fl_gains_at(sim.float(), cm, idx))
        assert torch.equal(got, ops.fl_gains_at(sim, cm, idx.to(torch.int32)))
        assert torch.equal(got, fl_gains_at_plain(sim, cm, idx))


def test_fl_wrappers_go_through_the_registered_operators(cuda):
    """ops.fl_gains / fl_gains_at call torch.ops.repro_torch.*: on the card
    the operator's CUDA implementation launches the kernel (and counts it),
    on meta tensors its fake one gives the shapes and launches nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func._schema.name)
            return func(*args, **(kwargs or {}))

    sim, cm = torch.rand((300, 200), device=cuda), torch.rand(300, device=cuda)
    idx = torch.tensor([0, 5, -1], device=cuda)
    before = dict(ops.LAUNCHES)
    with Seen() as seen:
        full, part = ops.fl_gains(sim, cm), ops.fl_gains_at(sim, cm, idx)
    assert seen.names == ["repro_torch::fl_gains", "repro_torch::fl_gains_at"]
    assert torch.equal(full, fl_gains_plain(sim, cm))
    assert torch.equal(part, fl_gains_at_plain(sim, cm, idx))
    assert ops.LAUNCHES["fl_gains"] == before["fl_gains"] + 1
    assert ops.LAUNCHES["fl_gains_at"] == before["fl_gains_at"] + 1
    meta = ops.fl_gains(sim.to("meta").bfloat16(), cm.to("meta"))
    assert meta.shape == (200,) and meta.dtype == torch.float32
    assert ops.LAUNCHES["fl_gains"] == before["fl_gains"] + 1


# the gathered FL sweep's widths: both sides of the crossover at n =
# FL_AT_N, every column and past it; u below one chunk, ragged, and past
# the first design's 8,388,480-row limit (with n = 8)
FL_AT_N = 20_000
FL_AT_EDGE = math.ceil(fl_module.FULL_SWEEP_RATIO * FL_AT_N)  # the crossover's first k
FL_AT_K = [1, 8, 64, 512, FL_AT_EDGE - 1, FL_AT_EDGE, FL_AT_N - 1, FL_AT_N + 3]
FL_AT_SHAPES = [(100, FL_AT_N), (1000, FL_AT_N), (65_535 * 128 + 1, 8)]


def _ids(g, cuda, n, k, dtype):
    """k ids in [0, n + 3) with pads (-1, the first among them), duplicates
    and ids >= n, which read item n - 1."""
    idx = torch.randint(0, n + 3, (k,), generator=g, device=cuda)
    idx[::7] = -1
    idx[1::5] = idx[0]
    return idx.to(dtype)


@pytest.mark.parametrize("route", ["rule", "gather", "every column"])
@pytest.mark.parametrize("shape", FL_AT_SHAPES)
def test_fl_gains_at_equals_full_and_plain_for_int32_and_int64(cuda, monkeypatch, shape, route):
    """One launch below the crossover, the full sweep and a gather from
    it past it (``route`` forces either): bit-equal to the full sweep and
    to the plain version at every width, with int32 and int64 ids, pads,
    duplicates and ids >= n; one count per call."""
    u, n = shape
    if route != "rule":
        monkeypatch.setattr(fl_module, "sweeps_every_column", lambda k, n_: route != "gather")
    g = torch.Generator(device=cuda).manual_seed(40)
    sim = torch.rand((u, n), generator=g, device=cuda)
    cm = 0.7 * torch.rand((u,), generator=g, device=cuda)
    full = ops.fl_gains(sim, cm)
    assert torch.equal(full, fl_gains_plain(sim, cm))
    for k in FL_AT_K if n == FL_AT_N else [1, 8, 9, 64]:
        idx = _ids(g, cuda, n, k, torch.int64)
        want = fl_gains_at_plain(sim, cm, idx)
        for dtype in (torch.int64, torch.int32):
            before = ops.LAUNCHES["fl_gains_at"]
            got = ops.fl_gains_at(sim, cm, idx.to(dtype))
            torch.cuda.synchronize()
            assert ops.LAUNCHES["fl_gains_at"] == before + 1
            _assert_subset(got, full, torch.clamp(idx, max=n - 1))
            assert torch.equal(got, want)


def _wave_stack(g, cuda, B, u, n, pad_rows=0):
    """B members of (u + pad_rows, n) on 512-byte slabs, as the batched
    engine stacks them (padded rows: S = 0, curmax = 0)."""
    rows = u + pad_rows
    stride = -(-rows * n // 128) * 128
    sim = torch.zeros(B * stride, device=cuda).as_strided((B, rows, n), (stride, n, 1))
    sim[:, :u] = torch.rand((B, u, n), generator=g, device=cuda)
    cm = torch.zeros((B, rows), device=cuda)
    cm[:, :u] = 0.7 * torch.rand((B, u), generator=g, device=cuda)
    return sim, cm


@pytest.mark.parametrize("B", [1, 3, 17])
@pytest.mark.parametrize("shape", [(1000, FL_AT_N), (131, 4096), (129, 1)])
def test_fl_wave_launch_equals_each_member_launch(cuda, B, shape):
    """One launch for the wave, counted once: member b's row equals its own
    launch and the plain version bit for bit, for the full sweep and the
    gathered sweep on both sides of the crossover, int32 and int64 ids
    (rows of a wider id tensor, as the lazy engine's sort hands them)."""
    u, n = shape
    g = torch.Generator(device=cuda).manual_seed(B * 7 + u)
    sim, cm = _wave_stack(g, cuda, B, u, n)
    before = dict(ops.LAUNCHES)
    full = ops.fl_gains(sim, cm)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fl_gains"] == before["fl_gains"] + 1
    assert torch.equal(full, fl_gains_plain(sim, cm))
    for b in range(B):
        assert torch.equal(full[b], ops.fl_gains(sim[b], cm[b]))
    edge = math.ceil(fl_module.FULL_SWEEP_RATIO * n)
    for k in sorted({1, 8, max(1, edge - 1), edge, n + 3}):
        wide = torch.stack([_ids(g, cuda, n, k + 5, torch.int64) for _ in range(B)])
        idx = wide[:, 2 : 2 + k]
        for dtype in (torch.int64, torch.int32):
            ids = idx if dtype == torch.int64 else wide.to(dtype)[:, 2 : 2 + k]
            count = ops.LAUNCHES["fl_gains_at"]
            got = ops.fl_gains_at(sim, cm, ids)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["fl_gains_at"] == count + 1
            assert torch.equal(got, fl_gains_at_plain(sim, cm, idx))
            for b in range(B):
                assert torch.equal(got[b], ops.fl_gains_at(sim[b], cm[b], ids[b].contiguous()))


def test_fl_wave_zero_padded_members_equal_unpadded_launches(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    u, n, pad = 1000, 3000, 300
    sim, cm = _wave_stack(g, cuda, 4, u, n, pad_rows=pad)
    full = ops.fl_gains(sim, cm)
    idx = torch.stack([_ids(g, cuda, n, 40, torch.int64) for _ in range(4)])
    part = ops.fl_gains_at(sim, cm, idx)
    torch.cuda.synchronize()
    for b in range(4):
        own_sim, own_cm = sim[b, :u].contiguous(), cm[b, :u].contiguous()
        assert torch.equal(full[b], ops.fl_gains(own_sim, own_cm))
        assert torch.equal(part[b], ops.fl_gains_at(own_sim, own_cm, idx[b]))


@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_batched_fl_wave_on_the_card_equals_sequential(cuda, optimizer, params):
    """solve(specs) on the card: one fl_gains launch per NaiveGreedy step
    (one fl_gains_at per LazyGreedy level) for the whole wave, and every
    member bit-equal to its sequential solve."""
    g = torch.Generator(device=cuda).manual_seed(11)
    fns = []
    for _ in range(5):
        x = torch.randn((KERNEL_MIN_N, 32), generator=g, device=cuda)
        fns.append(facility_location_from_arrays(
            torch.clamp(x @ x.T / 32.0, min=0.0).cpu().numpy(), use_kernel=True, device=cuda))
    budgets = [12, 5, 9, 12, 7]
    specs = [SelectionSpec(f, b, optimizer, **params) for f, b in zip(fns, budgets)]
    before = dict(ops.LAUNCHES)
    wave = solve(specs)
    torch.cuda.synchronize()
    if optimizer == "NaiveGreedy":
        assert ops.LAUNCHES["fl_gains"] - before["fl_gains"] == max(budgets)
    else:
        assert ops.LAUNCHES["fl_gains"] - before["fl_gains"] == 1  # the first bounds
    for s, r in zip(specs, wave):
        seq = result_to_numpy(solve(s))
        got = result_to_numpy(r)
        np.testing.assert_array_equal(got[0], seq[0])
        np.testing.assert_array_equal(got[1].view(np.int32), seq[1].view(np.int32))
        assert got[2] == seq[2] and np.float32(got[3]) == np.float32(seq[3])


@pytest.mark.parametrize("concave", ["sqrt", "log", "inverse"])
def test_fb_gains_at_equals_full_for_int32_and_int64(cuda, concave):
    """One launch that forms g(acc) in its term: bit-equal to the full
    sweep (which forms it once per feature) at every width, with int32 and
    int64 ids, pads, duplicates and ids >= n; the plain version's bits
    where torch's rounding is CUDA's (sqrt, inverse), its bar for log1p."""
    n, F = FL_AT_N, 257
    g = torch.Generator(device=cuda).manual_seed(41)
    feats = torch.rand((n, F), generator=g, device=cuda)
    acc = 3.0 * torch.rand((F,), generator=g, device=cuda)
    w = 0.5 + torch.rand((F,), generator=g, device=cuda)
    full = ops.fb_gains(feats, acc, w, concave)
    for k in FL_AT_K:
        idx = _ids(g, cuda, n, k, torch.int64)
        want = fb_gains_at_plain(feats, acc, w, idx, concave)
        for dtype in (torch.int64, torch.int32):
            before = ops.LAUNCHES["fb_gains_at"]
            got = ops.fb_gains_at(feats, acc, w, idx.to(dtype), concave)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["fb_gains_at"] == before + 1
            _assert_subset(got, full, torch.clamp(idx, max=n - 1))
            if concave == "log":
                torch.testing.assert_close(got, want, **COVER_TOL)
            else:
                assert torch.equal(got, want)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    s = torch.rand((8, 8), device=cuda)
    with pytest.raises(TypeError):
        ops.fl_gains(s.half(), torch.rand(8, device=cuda).half())
    with pytest.raises(ValueError, match="devices"):
        ops.fl_gains(s, torch.rand(8))


def test_argmax_takes_the_first_maximum_on_the_card(cuda):
    x = torch.tensor([0.5, 2.0, -1.0, 2.0, 2.0] * 1000, device=cuda)
    assert int(torch.argmax(x)) == 1


@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_card_solve_equals_cpu_kernel_order(cuda, optimizer, params):
    """On the card the path runs the CUDA sweeps; their plain versions add
    in the same order, so over one similarity the card's selection equals
    the CPU's use_kernel=True selection exactly."""
    rng = np.random.default_rng(9)
    sim = rng.uniform(0, 1, size=(300, KERNEL_MIN_N)).astype(np.float32)
    gpu_fn = facility_location_from_arrays(sim, use_kernel=None, device="cuda")
    assert backend_name(gpu_fn) == "cuda-fl"
    cpu_fn = facility_location_from_arrays(sim, use_kernel=True, device="cpu")
    got = result_to_numpy(solve(SelectionSpec(gpu_fn, 30, optimizer, **params)))
    want = result_to_numpy(solve(SelectionSpec(cpu_fn, 30, optimizer, **params)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def _assert_subset(got, full, idx):
    keep = idx >= 0
    assert torch.equal(got[keep], full[idx[keep].long()])
    assert bool((got[~keep] == NEG_INF).all())


def _mf_inputs(cuda, shape, metric, seed):
    u, n, d = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((u, d), generator=g, device=cuda)
    y = torch.randn((n, d), generator=g, device=cuda)
    if metric == "cosine":
        x, y = _normalize(x), _normalize(y)
    idx = [torch.randint(0, n, (k,), generator=g, device=cuda) for k in (1, 8, 100, 777)]
    for i in idx:
        i[::7] = -1
    return g, x, y, (x * x).sum(1), (y * y).sum(1), idx


def _gc_inputs(cuda, g, n):
    mask = (torch.rand((n,), generator=g, device=cuda) < 0.1).float()
    total = n * torch.rand((n,), generator=g, device=cuda)
    diag = torch.rand((n,), generator=g, device=cuda)
    return mask, total, diag, torch.tensor(0.4, device=cuda)


@pytest.mark.parametrize("shape", MF_SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_flmf_kernels_match_plain(cuda, shape, metric):
    """The kernel against its plain version, and the gathered kernel equal to
    the full kernel bit for bit, at ragged shapes (u, n, d not multiples of
    the tiles) and a one-column case."""
    g, x, y, xx, yy, idx = _mf_inputs(cuda, shape, metric, 3)
    cm = 0.8 * torch.rand((shape[0],), generator=g, device=cuda)
    before = dict(ops.LAUNCHES)
    full = ops.flmf_gains(x, y, xx, yy, cm, metric)
    torch.cuda.synchronize()
    torch.testing.assert_close(full, flmf_gains_plain(x, y, xx, yy, cm, metric), **MF_TOL[metric])
    for i in idx:
        got = ops.flmf_gains_at(x, y, xx, yy, cm, i, metric)
        torch.cuda.synchronize()
        _assert_subset(got, full, i)
        torch.testing.assert_close(got, flmf_gains_at_plain(x, y, xx, yy, cm, i, metric), **MF_TOL[metric])
    assert ops.LAUNCHES["flmf_gains"] == before["flmf_gains"] + 1
    assert ops.LAUNCHES["flmf_gains_at"] == before["flmf_gains_at"] + len(idx)


def _one_row_in(t):
    """A copy of the 2-D tensor ``t`` one row into a buffer: at d = 130 its
    rows of 520 bytes start 8 bytes off a 16-byte boundary."""
    view = torch.empty((t.shape[0] + 1, t.shape[1]), dtype=t.dtype, device=t.device)[1:]
    return view.copy_(t)


@pytest.mark.parametrize("metric", METRICS)
def test_flmf_kernels_on_offset_rows(cuda, monkeypatch, metric):
    """The pipelined flmf on rows offset by one row at d = 130 (the
    element-wise copies and a ragged last strip): against the plain version,
    the gathered sweep equal to the full one and column slices equal to one
    launch, bit for bit.  At d = 512 the element-wise copies of rows one
    element into a buffer give the 16-byte copies' bits, full and gathered."""
    g = torch.Generator(device=cuda).manual_seed(40)
    u, n = 300, 1500
    cm = 0.8 * torch.rand((u,), generator=g, device=cuda)
    idx = torch.randint(0, n, (777,), generator=g, device=cuda)
    idx[::7] = -1
    for d in (130, 512):
        x = torch.randn((u, d), generator=g, device=cuda)
        y = torch.randn((n, d), generator=g, device=cuda)
        if metric == "cosine":
            x, y = _normalize(x), _normalize(y)
        xx, yy = (x * x).sum(1), (y * y).sum(1)
        if d == 512:
            xo, yo = _offset_rows(x), _offset_rows(y)
            assert torch.equal(ops.flmf_gains(xo, yo, xx, yy, cm, metric),
                               ops.flmf_gains(x, y, xx, yy, cm, metric))
            assert torch.equal(ops.flmf_gains_at(xo, yo, xx, yy, cm, idx, metric),
                               ops.flmf_gains_at(x, y, xx, yy, cm, idx, metric))
            continue
        xo, yo = _one_row_in(x), _one_row_in(y)
        full = ops.flmf_gains(xo, yo, xx, yy, cm, metric)
        torch.cuda.synchronize()
        torch.testing.assert_close(full, flmf_gains_plain(x, y, xx, yy, cm, metric),
                                   **MF_TOL[metric])
        got = ops.flmf_gains_at(xo, yo, xx, yy, cm, idx, metric)
        _assert_subset(got, full, idx)
        monkeypatch.setattr(flmf_module, "SCRATCH_BYTES", 4 * 3 * 128)  # 3 blocks x 128 columns
        assert torch.equal(ops.flmf_gains(xo, yo, xx, yy, cm, metric), full)
        assert torch.equal(ops.flmf_gains_at(xo, yo, xx, yy, cm, idx, metric), got)
        monkeypatch.undo()


def test_flmf_and_sc_raise_instead_of_falling_back(cuda, monkeypatch):
    """A kernel that fails to launch, or a library that fails to build,
    raises: the wrappers never hand the call to the plain version or to
    another layout."""
    from repro_torch.kernels import _build

    x = torch.rand((300, 130), device=cuda)
    v = torch.rand(300, device=cuda)
    cover = (torch.rand((64, 1000), device=cuda) < 0.3).float()
    m = torch.rand(1000, device=cuda)
    calls = {
        "flmf_gains": lambda: ops.flmf_gains(x, x, v, v, v, "rbf"),
        "flmf_gains_at": lambda: ops.flmf_gains_at(x, x, v, v, v, v[:8].int(), "rbf"),
        "sc_gains": lambda: ops.sc_gains(cover, m, m),
    }
    real = _build.load()

    class Refusing:  # every launch refused, as by a kernel the card cannot run
        def __getattr__(self, name):
            if name.endswith("_launch"):
                return lambda *args: 98  # cudaErrorInvalidDeviceFunction
            return getattr(real, name)

    before = dict(ops.LAUNCHES)
    monkeypatch.setattr(_build, "load", lambda: Refusing())
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name.removesuffix('_at')} kernel: CUDA error 98"):
            call()
    monkeypatch.undo()

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_library_path", lambda: _build.BUILD_DIR / "absent.so")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    for call in calls.values():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("shape", MF_SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_gcmf_kernels_match_plain(cuda, shape, metric):
    _, n, _ = shape
    g, _, y, _, yy, idx = _mf_inputs(cuda, shape, metric, 4)
    mask, total, diag, lam = _gc_inputs(cuda, g, n)
    before = dict(ops.LAUNCHES)
    full = ops.gcmf_gains(y, yy, mask, total, diag, lam, metric)
    torch.cuda.synchronize()
    torch.testing.assert_close(full, gcmf_gains_plain(y, yy, mask, total, diag, lam, metric),
                               **MF_TOL[metric])
    for i in idx:
        got = ops.gcmf_gains_at(y, yy, mask, total, diag, lam, i, metric)
        torch.cuda.synchronize()
        _assert_subset(got, full, i)
        torch.testing.assert_close(
            got, gcmf_gains_at_plain(y, yy, mask, total, diag, lam, i, metric), **MF_TOL[metric])
    assert ops.LAUNCHES["gcmf_gains"] == before["gcmf_gains"] + 1
    assert ops.LAUNCHES["gcmf_gains_at"] == before["gcmf_gains_at"] + len(idx)


def _count_mask(cuda, g, n, k):
    """A 0/1 mask of k items in random places."""
    mask = torch.zeros((n,), device=cuda)
    mask[torch.randperm(n, generator=g, device=cuda)[:k]] = 1.0
    return mask


@pytest.mark.parametrize("count", ["0", "1", "127", "128", "129", "n"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n", [300, 256])
def test_gcmf_kernels_at_column_block_edges(cuda, n, metric, count):
    """The kernel computes only the selected columns, 128 compacted columns
    to a block: at |A| one short of, at and one past a block, with none and
    with every column selected, the gathered sweep (k = 1, 8, 100, 777, pads
    included) equals the full sweep bit for bit and both match the plain
    versions; with none selected every gain is total - lam * diag."""
    g, _, y, _, yy, idx = _mf_inputs(cuda, (1, n, 130), metric, 9)
    _, total, diag, lam = _gc_inputs(cuda, g, n)
    mask = _count_mask(cuda, g, n, n if count == "n" else int(count))
    args = (y, yy, mask, total, diag, lam)
    full = ops.gcmf_gains(*args, metric)
    torch.cuda.synchronize()
    torch.testing.assert_close(full, gcmf_gains_plain(*args, metric), **MF_TOL[metric])
    if count == "0":
        assert torch.equal(full, total - lam * diag)
    for i in idx:
        got = ops.gcmf_gains_at(*args, i, metric)
        torch.cuda.synchronize()
        _assert_subset(got, full, i)
        torch.testing.assert_close(got, gcmf_gains_at_plain(*args, i, metric), **MF_TOL[metric])


@pytest.mark.parametrize("pred", ["positive", "nonzero"])
def test_select_cols_kernel_equals_nonzero(cuda, pred):
    """The compaction on the card equals torch.nonzero at n = 2^20 (256
    scan blocks) and at a ragged n, for empty, single, sparse, dense and
    full masks with negative entries, and gives the same list on a rerun."""
    g = torch.Generator(device=cuda).manual_seed(10)
    for n in (1 << 20, 4096 * 3 + 17):
        r = torch.rand((n,), generator=g, device=cuda)
        for mask in (torch.zeros((n,), device=cuda), _count_mask(cuda, g, n, 1),
                     torch.where(r < 0.01, 1.0, 0.0), torch.where(r < 0.5, r - 0.25, 0.0),
                     torch.ones((n,), device=cuda)):
            sel, count = select_cols(mask, pred)
            again, _ = select_cols(mask, pred)
            torch.cuda.synchronize()
            want = torch.nonzero(mask > 0 if pred == "positive" else mask != 0).flatten()
            k = int(count)
            assert k == want.numel()
            assert torch.equal(sel[:k].long(), want)
            assert torch.equal(again[:k], sel[:k])


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_mf_sweeps_in_column_slices_equal_one_launch(cuda, monkeypatch, metric):
    """A sweep run in slices of 128 columns (the scratch cap at its least)
    equals the same sweep in one launch bit for bit, full and gathered."""
    g, x, y, xx, yy, idx = _mf_inputs(cuda, (1000, 777, 130), metric, 7)
    cm = 0.8 * torch.rand((1000,), generator=g, device=cuda)
    gc = (y, yy, *_gc_inputs(cuda, g, 777))
    whole = [ops.flmf_gains(x, y, xx, yy, cm, metric), ops.gcmf_gains(*gc, metric)]
    whole += [ops.flmf_gains_at(x, y, xx, yy, cm, idx[3], metric),
              ops.gcmf_gains_at(*gc, idx[3], metric)]
    monkeypatch.setattr(flmf_module, "SCRATCH_BYTES", 4 * 8 * 128)  # 8 blocks x 128 columns
    sliced = [ops.flmf_gains(x, y, xx, yy, cm, metric), ops.gcmf_gains(*gc, metric)]
    sliced += [ops.flmf_gains_at(x, y, xx, yy, cm, idx[3], metric),
               ops.gcmf_gains_at(*gc, idx[3], metric)]
    torch.cuda.synchronize()
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)


def test_mf_square_sweep_memory_is_capped(cuda):
    """At n = 2^17 a square sweep's device memory beyond its inputs is the
    output, the slicing index and the capped partial scratch: O(n), where an
    uncapped (n / 128, n) scratch would take 512 MiB."""
    n, d = 1 << 17, 64
    g = torch.Generator(device=cuda).manual_seed(8)
    y = _normalize(torch.randn((n, d), generator=g, device=cuda))
    yy = (y * y).sum(1)
    cm = 0.5 * torch.rand((n,), generator=g, device=cuda)
    mask, total, diag, lam = _gc_inputs(cuda, g, n)
    # total = 0: the gain is then the kernel's own sum (~n / 20 here), held
    # to rtol; a random total of ~n would cancel it to near 0 and leave its
    # fp32 rounding (1e-6 of the sum) to an absolute bar
    gc = (y, yy, mask, torch.zeros_like(total), diag, lam)
    sweeps = {
        "flmf": (lambda: ops.flmf_gains(y, y, yy, yy, cm, "cosine"),
                 lambda: flmf_gains_plain(y, y, yy, yy, cm, "cosine")),
        "gcmf": (lambda: ops.gcmf_gains(*gc, "cosine"),
                 lambda: gcmf_gains_plain(*gc, "cosine")),
    }
    limit = SCRATCH_BYTES + 2 * 4 * n + (1 << 20)
    for name, (kernel, plain) in sweeps.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = kernel()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        assert extra <= limit, f"{name}: {extra} bytes beyond the inputs, limit {limit}"
        torch.testing.assert_close(got, plain(), **MF_TOL["cosine"])


@pytest.mark.parametrize("metric", METRICS)
def test_feature_source_subset_sweep_is_bit_equal_on_the_card(cuda, metric):
    """The torch path's gathered sweep equals its full sweep bit for bit on
    the card too (cuBLAS at one fixed tile shape), and so does a column."""
    g, x, y, _, _, idx = _mf_inputs(cuda, (300, 1500, 130), "dot", 5)
    src = feature_source(x, y, metric)
    cm = 0.5 * torch.rand((300,), generator=g, device=cuda)
    full = src.fl_gains(cm)
    for i in idx:
        _assert_subset(src.fl_gains_at(cm, i), full, i)
    _, _, block = next(src._tiles())  # col(j) is the sweep's own column
    assert torch.equal(src.col(torch.tensor([17], device=cuda)), block[:, 17])


@pytest.mark.parametrize("family", ["fl", "gc"])
@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_mf_card_solve_matches_the_plain_path(cuda, family, optimizer, params):
    """FacilityLocationMF / GraphCutMF on the card: the CUDA sweeps pick the
    torch path's ids, with gains to 1e-5."""
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(20, 64)).astype(np.float32)
    x = centers[rng.integers(0, 20, 3000)] + rng.normal(size=(3000, 64)).astype(np.float32)
    if family == "fl":
        fn = FacilityLocationMF.from_features(x, metric="cosine", use_kernel=True)
    else:
        fn = GraphCutMF.from_features(x, lam=0.4, metric="cosine", use_kernel=True)
    assert backend_name(fn) == ("cuda-flmf" if family == "fl" else "cuda-gcmf")
    got = result_to_numpy(solve(SelectionSpec(fn, 20, optimizer, **params)))
    want = result_to_numpy(solve(SelectionSpec(fn, 20, optimizer, use_kernel=False, **params)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert got[2] == want[2]


def test_mf_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.rand((8, 4), device=cuda)
    v = torch.rand(8, device=cuda)
    with pytest.raises(ValueError, match="devices"):
        ops.flmf_gains(x, x, v, v, torch.rand(8), "dot")
    with pytest.raises(TypeError, match="lam"):
        ops.gcmf_gains(x, v, v, v, v, 0.4, "dot")


# -- the dense pairwise kernels: gc, gc_at, dsum, dmin ---------------------------

DENSE_N = [8, 100, 257, 4096, 9000]  # 9000 = 35 * 256 + 40: ragged across the block


def _dense_inputs(cuda, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    s = torch.rand((n, n), generator=g, device=cuda)
    mask = (torch.rand((n,), generator=g, device=cuda) < 0.3).float()
    return g, s, mask


@pytest.mark.parametrize("n", DENSE_N)
def test_gc_kernels_equal_plain_bit_for_bit(cuda, n):
    """Kernel and plain version reduce each row in the same order with the
    same roundings; the gathered kernel equals the full kernel at the same
    index, with duplicates, pads and indices >= n (read as row n - 1)."""
    g, s, mask = _dense_inputs(cuda, n, 20)
    total, lam = s.sum(dim=0), torch.tensor(0.4, device=cuda)
    before = dict(ops.LAUNCHES)
    full = ops.gc_gains(s, mask, total, lam)
    torch.cuda.synchronize()
    assert torch.equal(full, gc_gains_plain(s, mask, total, lam))
    for k in (1, 8, 100, 777):
        idx = torch.randint(0, n + 3, (k,), generator=g, device=cuda)
        idx[::7] = -1
        idx[1::5] = idx[0]  # duplicates
        got = ops.gc_gains_at(s, mask, total, lam, idx)
        torch.cuda.synchronize()
        _assert_subset(got, full, torch.clamp(idx, max=n - 1))
        assert torch.equal(got, gc_gains_at_plain(s, mask, total, lam, idx))
    assert ops.LAUNCHES["gc_gains"] == before["gc_gains"] + 1
    assert ops.LAUNCHES["gc_gains_at"] == before["gc_gains_at"] + 4


@pytest.mark.parametrize("n", DENSE_N)
def test_disp_kernels_equal_plain_bit_for_bit(cuda, n):
    _, d, mask = _dense_inputs(cuda, n, 21)
    count = mask.sum().to(torch.int32)
    curmin = torch.tensor(0.05, device=cuda)
    got = ops.dsum_gains(d, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, dsum_gains_plain(d, mask))
    got = ops.dmin_gains(d, mask, count, curmin)
    torch.cuda.synchronize()
    assert torch.equal(got, dmin_gains_plain(d, mask, count, curmin))
    empty = ops.dmin_gains(d, torch.zeros_like(mask), torch.zeros_like(count), torch.zeros_like(curmin))
    assert torch.equal(empty, torch.zeros_like(empty))  # |A| = 0: every gain is 0


# gc / dsum selections: |A| = 0, 1, a warp's 32 lanes and one either side,
# n/8, every item, a random 30% with signed fractional weights, and around
# the staged chunk of SEL_CHUNK list positions (|A| capped at n)
SUM_COUNTS = {"0": 0, "1": 1, "31": 31, "32": 32, "33": 33, "chunk-1": SEL_CHUNK - 1,
              "chunk": SEL_CHUNK, "chunk+1": SEL_CHUNK + 1, "2chunk+1": 2 * SEL_CHUNK + 1}
SUM_N = [100, 257, 1500, 9000]  # none a multiple of 32 or of SEL_CHUNK


def _sum_mask(cuda, g, n, which):
    if which == "signed":
        r = torch.rand((n,), generator=g, device=cuda)
        return torch.where(r < 0.3, 4.0 * r - 0.5, 0.0)  # in [-0.5, 0.7), some negative
    k = n if which == "n" else n // 8 if which == "n/8" else min(n, SUM_COUNTS[which])
    return _count_mask(cuda, g, n, k)


def _check_selected_sums(cuda, g, s, mask):
    """gc, gc_at and dsum kernels against their plain versions, bit for bit,
    and gc_at against gc at the same index (in A, not in A, clipped, pads)."""
    n = s.shape[0]
    total, lam = s.sum(dim=0), torch.tensor(0.4, device=cuda)
    full = ops.gc_gains(s, mask, total, lam)
    torch.cuda.synchronize()
    assert torch.equal(full, gc_gains_plain(s, mask, total, lam))
    picked = torch.nonzero(mask).flatten()[:40]
    idx = torch.cat([picked, torch.randint(0, n + 3, (100,), generator=g, device=cuda),
                     torch.tensor([-1, n - 1, n + 5], device=cuda)])
    got = ops.gc_gains_at(s, mask, total, lam, idx)
    torch.cuda.synchronize()
    _assert_subset(got, full, torch.clamp(idx, max=n - 1))
    assert torch.equal(got, gc_gains_at_plain(s, mask, total, lam, idx))
    got = ops.dsum_gains(s, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, dsum_gains_plain(s, mask))
    return full


@pytest.mark.parametrize("which", [*SUM_COUNTS, "n/8", "n", "signed"])
@pytest.mark.parametrize("n", SUM_N)
def test_selected_sum_kernels_equal_plain_bit_for_bit(cuda, n, which):
    """gc and dsum sum the selected columns in one fixed order for every |A|
    (across the warp's lanes and the staged chunk, up to every column) and
    equal their plain versions bit for bit; |A| = 0 gives 0 and
    total - lam * S_jj."""
    g, s, _ = _dense_inputs(cuda, n, 23)
    mask = _sum_mask(cuda, g, n, which)
    full = _check_selected_sums(cuda, g, s, mask)
    if which == "0":
        assert torch.equal(ops.dsum_gains(s, mask), torch.zeros_like(full))
        assert torch.equal(full, s.sum(dim=0) - torch.tensor(0.4, device=cuda) * torch.diagonal(s))


def test_selected_sum_kernels_past_int32_offsets(cuda):
    """n = 46,341: n^2 > 2^31, so the last rows' element offsets need 64
    bits (8.6 GB of S)."""
    n = 46_341
    g = torch.Generator(device=cuda).manual_seed(24)
    s = torch.rand((n, n), generator=g, device=cuda)
    mask = _count_mask(cuda, g, n, 1000)
    mask[n - 1] = 1.0  # the last column, in the last row at offset n^2 - 1
    _check_selected_sums(cuda, g, s, mask)


@pytest.mark.parametrize("count", ["1", "n/8-1", "n/8", "n/8+1", "n"])
@pytest.mark.parametrize("n", DENSE_N)
def test_dmin_kernel_both_branches_equal_plain_bit_for_bit(cuda, n, count):
    """The kernel gathers the selected columns while 8 |A| < n (|A| = 1,
    n/8 - 1) and streams every column from 8 |A| = n on (n/8, n/8 + 1, n);
    either way it equals its plain version bit for bit."""
    g, d, _ = _dense_inputs(cuda, n, 22)
    k = {"1": 1, "n/8-1": n // 8 - 1, "n/8": n // 8, "n/8+1": n // 8 + 1, "n": n}[count]
    mask = _count_mask(cuda, g, n, k)
    cnt = torch.tensor(k, dtype=torch.int32, device=cuda)
    curmin = torch.tensor(0.05 if k else 0.0, device=cuda)
    got = ops.dmin_gains(d, mask, cnt, curmin)
    torch.cuda.synchronize()
    assert torch.equal(got, dmin_gains_plain(d, mask, cnt, curmin))


@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_dense_pairwise_card_solves(cuda, optimizer, params):
    """GraphCut and DisparitySum on the card (CUDA sweeps) equal the CPU's
    use_kernel=True selection exactly (the plain versions add in the
    kernels' order); DisparityMin's kernel path equals its own torch path
    bit for bit, ids and gains."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(KERNEL_MIN_N, 32)).astype(np.float32)
    sim = (x @ x.T / 32.0).astype(np.float32)
    sq = (x * x).sum(1)
    dist = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * x @ x.T, 0.0)).astype(np.float32)
    total = sim.sum(axis=0)  # one total for both devices: the gains then come from the sweeps alone
    for make in (lambda dev: graph_cut_from_arrays(sim, total, 0.3, use_kernel=True, device=dev),
                 lambda dev: DisparitySum.from_distance(dist, use_kernel=True, device=dev)):
        got = result_to_numpy(solve(SelectionSpec(make("cuda"), 20, optimizer, **params)))
        want = result_to_numpy(solve(SelectionSpec(make("cpu"), 20, optimizer, **params)))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    fn = DisparityMin.from_distance(dist, use_kernel=True, device="cuda")
    assert backend_name(fn) == "cuda-dmin"
    before = ops.LAUNCHES["dmin_gains"]
    got = result_to_numpy(solve(SelectionSpec(fn, 20, optimizer, stopIfNegativeGain=False, **params)))
    assert ops.LAUNCHES["dmin_gains"] > before
    want = result_to_numpy(solve(SelectionSpec(fn, 20, optimizer, use_kernel=False,
                                               stopIfNegativeGain=False, **params)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_dense_wrappers_raise_instead_of_falling_back(cuda):
    s = torch.rand((8, 8), device=cuda)
    v = torch.rand(8, device=cuda)
    lam, cnt = torch.tensor(0.4, device=cuda), torch.tensor(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="devices"):
        ops.gc_gains(s, v, torch.rand(8), lam)
    with pytest.raises(ValueError, match="idx on"):
        ops.gc_gains_at(s, v, v, lam, torch.tensor([0]))
    with pytest.raises(TypeError, match="float32"):
        ops.dsum_gains(s.half(), v)
    with pytest.raises(ValueError, match="devices"):
        ops.dmin_gains(s, v, cnt.cpu(), lam)
    with pytest.raises(TypeError, match="count"):
        ops.dmin_gains(s, v, cnt.long(), lam)


# -- the coverage kernels: fb, fb_at, sc, psc ------------------------------------

# ragged row widths across the warp's 32 lanes and its 8-load unroll
COVER_SHAPES = [(1, 1), (7, 33), (257, 255), (4097, 257), (4097, 1000)]
COVER_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("concave", ["sqrt", "log", "inverse"])
@pytest.mark.parametrize("shape", COVER_SHAPES)
def test_fb_kernels_match_plain(cuda, shape, concave):
    """Kernel and plain version sum each row in the same order; sqrt and
    the division round as IEEE on both, log1p is CUDA's log1pf on both
    (held to 1e-5).  The gathered kernel equals the full kernel bit for bit
    at the same index, with duplicates, pads and indices >= n."""
    n, F = shape
    g = torch.Generator(device=cuda).manual_seed(30)
    feats = torch.rand((n, F), generator=g, device=cuda)
    acc = 3.0 * torch.rand((F,), generator=g, device=cuda)
    w = 0.5 + torch.rand((F,), generator=g, device=cuda)
    before = dict(ops.LAUNCHES)
    full = ops.fb_gains(feats, acc, w, concave)
    torch.cuda.synchronize()
    want = fb_gains_plain(feats, acc, w, concave)
    torch.testing.assert_close(full, want, **COVER_TOL)
    if concave != "log":
        assert torch.equal(full, want)
    for k in (1, 8, 100, 777):
        idx = torch.randint(0, n + 3, (k,), generator=g, device=cuda)
        idx[::7] = -1
        idx[1::5] = idx[0]  # duplicates
        got = ops.fb_gains_at(feats, acc, w, idx, concave)
        torch.cuda.synchronize()
        _assert_subset(got, full, torch.clamp(idx, max=n - 1))
        torch.testing.assert_close(got, fb_gains_at_plain(feats, acc, w, idx, concave), **COVER_TOL)
    assert ops.LAUNCHES["fb_gains"] == before["fb_gains"] + 1
    assert ops.LAUNCHES["fb_gains_at"] == before["fb_gains_at"] + 4


@pytest.mark.parametrize("shape", COVER_SHAPES)
def test_sc_kernels_equal_plain_bit_for_bit(cuda, shape):
    """Products and sums in the same order with the same roundings: sc (a
    fractional covered, non-unit weights) and psc equal their plain versions
    bit for bit."""
    n, m = shape
    g = torch.Generator(device=cuda).manual_seed(31)
    cover = (torch.rand((n, m), generator=g, device=cuda) < 0.3).float()
    covered = torch.rand((m,), generator=g, device=cuda)
    w = 0.5 + torch.rand((m,), generator=g, device=cuda)
    probs = torch.rand((n, m), generator=g, device=cuda)
    miss = torch.rand((m,), generator=g, device=cuda)
    before = dict(ops.LAUNCHES)
    got = ops.sc_gains(cover, covered, w)
    torch.cuda.synchronize()
    assert torch.equal(got, sc_gains_plain(cover, covered, w))
    got = ops.psc_gains(probs, miss, w)
    torch.cuda.synchronize()
    assert torch.equal(got, psc_gains_plain(probs, w * miss))
    assert ops.LAUNCHES["sc_gains"] == before["sc_gains"] + 1
    assert ops.LAUNCHES["psc_gains"] == before["psc_gains"] + 1


# the vector warp layout's cases: one concept; fewer than one 128-wide round;
# m % 4 != 0 (element loads, a short last chunk); whole and ragged rounds
SC_M = [1, 3, 4, 33, 127, 128, 130, 257, 1000, 1001]


@pytest.mark.parametrize("m", SC_M)
def test_sc_kernel_both_load_paths_equal_plain_bit_for_bit(cuda, m):
    """sc_gains (a fractional covered, non-unit weights) equals its plain
    version bit for bit on the 16-byte loads (m % 4 == 0, aligned) and on
    the element loads: a cover one element into a buffer, a column slice of
    a wider matrix made contiguous there, and vectors that are not 16-byte
    aligned."""
    n = 4099  # row groups of the persistent grid do not divide it
    g = torch.Generator(device=cuda).manual_seed(32 + m)
    wide = (torch.rand((n, m + 3), generator=g, device=cuda) < 0.3).float()
    cover = wide[:, 1 : m + 1].contiguous()
    covered = torch.rand((m,), generator=g, device=cuda)
    w = 0.5 + torch.rand((m,), generator=g, device=cuda)
    want = sc_gains_plain(cover, covered, w)
    before = ops.LAUNCHES["sc_gains"]
    got = ops.sc_gains(cover, covered, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    sliced = torch.empty((n * m + 1,), device=cuda)[1:].view(n, m).copy_(wide[:, 1 : m + 1])
    assert sliced.data_ptr() % 16
    assert torch.equal(ops.sc_gains(sliced, covered, w), want)
    vecs = torch.empty((2 * m + 1,), device=cuda)[1:]
    vecs[:m], vecs[m:] = covered, w
    assert torch.equal(ops.sc_gains(cover, vecs[:m], vecs[m:]), want)
    assert ops.LAUNCHES["sc_gains"] == before + 3
    ones = torch.ones((m,), device=cuda)
    binary = (covered < 0.5).float()
    assert torch.equal(ops.sc_gains(cover, binary, ones),
                       torch.clamp(cover - binary, min=0.0).sum(1))


@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_coverage_card_solves(cuda, optimizer, params):
    """SetCover with unit weights: the card's kernel path, its torch path and
    the CPU agree exactly (integer gains).  FeatureBased (inverse): the
    card's kernel path equals the CPU's use_kernel=True path exactly (IEEE
    division on both, one order; torch's CPU sqrt is not correctly rounded
    and its log1p is not CUDA's, so those concaves agree across devices to
    ulps only).  ProbabilisticSetCover: the kernel path against the card's torch
    path, ids equal and gains to 1e-5."""
    rng = np.random.default_rng(13)
    n, m = KERNEL_MIN_N, 200
    cover = (rng.uniform(size=(n, m)) < 0.02).astype(np.float32)
    feats = rng.uniform(0, 1, size=(n, m)).astype(np.float32)
    probs = rng.uniform(0, 0.05, size=(n, m)).astype(np.float32)
    runs = {}
    for dev, uk in (("cuda", True), ("cuda", False), ("cpu", True)):
        sc = SetCover.from_cover(cover, use_kernel=uk, device=dev)
        runs[dev, uk] = result_to_numpy(solve(SelectionSpec(sc, 30, optimizer, **params)))
    for key in (("cuda", False), ("cpu", True)):
        for a, b in zip(runs["cuda", True][:3], runs[key][:3]):
            np.testing.assert_array_equal(a, b)
    fb = [FeatureBased.from_features(feats, concave="inverse", use_kernel=True, device=dev)
          for dev in ("cuda", "cpu")]
    got, want = (result_to_numpy(solve(SelectionSpec(f, 30, optimizer, **params))) for f in fb)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    psc = ProbabilisticSetCover.from_probs(probs, use_kernel=True, device="cuda")
    assert backend_name(psc) == "cuda-psc"
    before = ops.LAUNCHES["psc_gains"]
    got = result_to_numpy(solve(SelectionSpec(psc, 30, optimizer, **params)))
    assert ops.LAUNCHES["psc_gains"] > before
    want = result_to_numpy(solve(SelectionSpec(psc, 30, optimizer, use_kernel=False, **params)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


def test_coverage_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.rand((8, 6), device=cuda)
    v = torch.rand(6, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ops.fb_gains(x.to(torch.bfloat16), v, v)  # bf16 feats are not ported
    with pytest.raises(TypeError, match="float32"):
        ops.fb_gains_at(x, v.double(), v, torch.tensor([0], device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.sc_gains(torch.rand((6, 8), device=cuda).T, v, v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.psc_gains(x[:, ::2], v[:3], v[:3])
    with pytest.raises(TypeError, match="float32"):
        ops.psc_gains(x.half(), v, v)
    with pytest.raises(ValueError, match="devices"):
        ops.sc_gains(x, v, torch.rand(6))
    with pytest.raises(ValueError, match="idx on"):
        ops.fb_gains_at(x, v, v, torch.tensor([0]))


# the fused sweep against its plain version: the same fp32 sums over dot
# products that the kernel's fmaf chain and the plain version's matmul round
# differently (the matrix-free dot bar)
FUSED_SHAPES = [(40, 60, 16), (300, 700, 128), (513, 1025, 80), (129, 1, 8), (1, 300, 13),
                (700, 5000, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_fl_sweep_kernel_matches_plain(cuda, shape, dtype):
    """On the card: the fused kernel against its plain version; a bf16 sweep
    equals the fp32 sweep of the widened features bit for bit, and an fp32
    sweep equals flmf_gains(dot) bit for bit (the same tile and order)."""
    u, n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(u * 7 + n)
    x = torch.randn((u, d), generator=gen, device=cuda).to(dtype)
    y = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    cm = 2.0 * torch.rand((u,), generator=gen, device=cuda)
    before = ops.LAUNCHES["fused_fl_sweep"]
    got = ops.fused_fl_sweep(x, y, cm)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_fl_sweep"] == before + 1
    torch.testing.assert_close(got, fused_fl_sweep_plain(x, y, cm), **MF_TOL["dot"])
    xf, yf = x.float(), y.float()
    assert torch.equal(got, ops.fused_fl_sweep(xf, yf, cm))
    assert torch.equal(ops.fused_fl_sweep(x, yf, cm), got)
    assert torch.equal(got, ops.flmf_gains(xf, yf, (xf * xf).sum(1), (yf * yf).sum(1), cm, "dot"))


@pytest.mark.parametrize("shape", UNALIGNED_SHAPES)
@pytest.mark.parametrize("d", UNALIGNED_D)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_fl_sweep_kernel_on_unaligned_rows(cuda, dtype, d, shape):
    """Unaligned rows take the element-wise load path (4-byte copies for
    fp32, element loads for bf16) and give the bits of the same call on
    aligned rows (the 16-byte path where fp32 d % 4 == 0, bf16 d % 8 == 0),
    alone or beside an aligned operand."""
    u, n = shape
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((u, d), generator=gen, device=cuda).to(dtype)
    y = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    cm = 2.0 * torch.rand((u,), generator=gen, device=cuda)
    before = ops.LAUNCHES["fused_fl_sweep"]
    got = ops.fused_fl_sweep(_offset_rows(x), _offset_rows(y), cm)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_fl_sweep"] == before + 1
    assert torch.equal(got, ops.fused_fl_sweep(x, y, cm))
    assert torch.equal(got, ops.fused_fl_sweep(x, _offset_rows(y), cm))
    assert torch.equal(got, ops.fused_fl_sweep(_offset_rows(x).float(), y, cm))
    torch.testing.assert_close(got, fused_fl_sweep_plain(x, y, cm), **MF_TOL["dot"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_fl_sweep_column_slices_bit_identical(cuda, dtype, monkeypatch):
    """fused(y)[cols] == fused(y[cols]) bit for bit, for slices, gathers and
    a sweep cut into column slices by a small scratch cap."""
    from repro_torch.kernels import flmf_gains as flmf_module

    gen = torch.Generator(device=cuda).manual_seed(29)
    u, n, d = 300, 3000, 72
    x = torch.randn((u, d), generator=gen, device=cuda).to(dtype)
    y = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    cm = torch.rand((u,), generator=gen, device=cuda)
    full = ops.fused_fl_sweep(x, y, cm)
    for lo, hi in ((0, 1), (5, 517), (128, 2048), (2999, 3000)):
        assert torch.equal(ops.fused_fl_sweep(x, y[lo:hi].contiguous(), cm), full[lo:hi])
    idx = torch.randint(0, n, (777,), generator=gen, device=cuda)
    assert torch.equal(ops.fused_fl_sweep(x, y[idx].contiguous(), cm), full[idx])
    monkeypatch.setattr(flmf_module, "SCRATCH_BYTES", 3 * 4 * 128 * 3)  # 384-column slices
    assert torch.equal(ops.fused_fl_sweep(x, y, cm), full)


def test_fused_fl_sweep_raises_instead_of_falling_back(cuda):
    x, y, cm = (torch.rand((8, 4), device=cuda), torch.rand((6, 4), device=cuda),
                torch.rand(8, device=cuda))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fused_fl_sweep(x.half(), y, cm)
    with pytest.raises(ValueError, match="devices"):
        ops.fused_fl_sweep(x, y.cpu(), cm)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_fl_sweep(x, torch.rand((4, 6), device=cuda).T, cm)


# -- the served path: served against sequential, bit for bit -----------------

SERVED_N = (3072, 4096, 6144)
SERVED_KINDS = ("fl", "gc", "fb", "sc", "psc", "dsum", "dmin", "flmf", "gcmf")


def _served_fn(kind, n, seed, cuda):
    """One request of a kernel family (use_kernel=None: the decision table
    picks the route by the request's own n) over a random cosine S / its
    features on the card."""
    from repro_torch.core import FacilityLocation, GraphCut, create_kernel

    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((n, 64), generator=gen, device=cuda)
    if kind in ("fl", "gc", "dsum", "dmin"):
        S = create_kernel(x, metric="cosine", use_pallas=True)
        if kind == "fl":
            return FacilityLocation.from_kernel(S, use_kernel=None)
        if kind == "gc":
            return GraphCut.from_kernel(S, lam=0.4, use_kernel=None)
        cls = DisparitySum if kind == "dsum" else DisparityMin
        return cls.from_distance(1.0 - S, use_kernel=None)
    if kind == "fb":
        return FeatureBased.from_features(torch.relu(x), use_kernel=None)
    if kind in ("sc", "psc"):
        p = torch.sigmoid(x @ torch.randn((64, 200), generator=gen, device=cuda) / 8.0 - 2.0)
        if kind == "sc":
            return SetCover.from_cover((p > 0.5).float(), use_kernel=None)
        return ProbabilisticSetCover.from_probs(p, use_kernel=None)
    cls = FacilityLocationMF if kind == "flmf" else GraphCutMF
    kw = {} if kind == "flmf" else {"lam": 0.4}
    return cls.from_features(x, metric="cosine", use_kernel=None, **kw)


def _served_specs(cuda):
    specs = []
    for i, kind in enumerate(SERVED_KINDS):
        for j, n in enumerate(SERVED_N):
            opt = ("NaiveGreedy", "LazyGreedy")[(i + j) % 2]
            stop = kind not in ("dsum", "dmin")
            specs.append(SelectionSpec(_served_fn(kind, n, 100 * i + j, cuda), 40, opt,
                                       stopIfZeroGain=stop, stopIfNegativeGain=stop))
    return specs


def _bits(a, b, what):
    oa, ga, ea, va = result_to_numpy(a)
    ob, gb, eb, vb = result_to_numpy(b)
    np.testing.assert_array_equal(oa, ob, err_msg=what)
    np.testing.assert_array_equal(ga.view(np.int32), gb.view(np.int32), err_msg=what)
    assert ea == eb and np.float32(va).view(np.int32) == np.float32(vb).view(np.int32), what


def test_served_equals_sequential_on_the_card(cuda):
    """One request per kernel family at n = 3,072, 4,096 and 6,144 through
    SelectionServer: each answer bit-equal to its sequential solve, on the
    route that solve takes (a padded family's 3,072 pads into the 4,096
    bucket and stays on the torch sweeps under KERNEL_MIN_N; FL and FLMF
    ride at their own n; the rest launch their kernels)."""
    from repro_torch.launch.serve import SelectionServer

    specs = _served_specs(cuda)
    seq = [solve(s) for s in specs]
    ops.reset_launches()
    responses = SelectionServer().select(specs)
    assert sum(ops.LAUNCHES.values()) > 0
    for s, r, q in zip(specs, responses, seq):
        what = f"{type(s.fn).__name__} n={s.fn.n} {s.optimizer.name}"
        _bits(r.result, q, what)
        assert r.backend == backend_name(s.fn) and r.attempts == 1, what
        matrix_free = isinstance(s.fn, (FacilityLocationMF, GraphCutMF))
        assert r.backend.startswith("cuda-") == (matrix_free or s.fn.n >= KERNEL_MIN_N), what


def test_served_async_equals_sequential_on_the_card(cuda):
    from repro_torch.launch.async_serve import AsyncSelectionServer

    specs = _served_specs(cuda)[::2]
    seq = [solve(s) for s in specs]
    with AsyncSelectionServer(max_pending=2, flush_interval=0.02) as front:
        futures = [front.submit(s) for s in specs]
        responses = [f.result(timeout=600) for f in futures]
    for s, r, q in zip(specs, responses, seq):
        _bits(r.result, q, f"{type(s.fn).__name__} n={s.fn.n}")


def test_served_torch_route_is_padding_invariant_on_the_card(cuda):
    """Zero-padded requests on the torch route (here forced, 6,144
    candidates padded to 8,192) equal their sequential solves on the card
    too: FLQMI's column sums under its 16 query rows fold in an order set
    by the row count alone (common.row_sums_fixed), GraphCut pads both
    axes; FL rides at its own n."""
    from repro_torch.core import FLQMI, FacilityLocation, GraphCut, create_kernel
    from repro_torch.launch.serve import SelectionServer

    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((6144, 64), generator=gen, device=cuda)
    q = torch.randn((16, 64), generator=gen, device=cuda)
    S = create_kernel(x, metric="cosine")
    fns = [FLQMI.build(create_kernel(q, x, metric="cosine")),
           GraphCut.from_kernel(S, lam=0.4, use_kernel=False),
           FacilityLocation.from_kernel(S, use_kernel=False)]
    specs = [SelectionSpec(f, 30, opt) for f in fns for opt in ("NaiveGreedy", "LazyGreedy")]
    for s, r in zip(specs, SelectionServer().select(specs)):
        want = 6144 if isinstance(s.fn, FacilityLocation) else 8192
        assert r.n_bucket == want and r.backend == "torch"
        _bits(r.result, solve(s), f"{type(s.fn).__name__} {s.optimizer.name}")


# -- the remaining optimizers: stride-0 rung waves, seeded draws, streaming --


@pytest.mark.parametrize("members,k", [(57, 32), (13, 1024), (3, 1)])
def test_fl_gains_at_with_member_stride_zero(cuda, members, k):
    """The streaming sieves sweep one S at many states: a member-stride-0
    view of S, one launch, bit-equal to the plain version and to one call
    per member."""
    from repro_torch.common import stacked_view

    g = torch.Generator(device=cuda).manual_seed(5)
    sim = torch.rand((5000, 6000), generator=g, device=cuda)
    wave = stacked_view([sim] * members)
    assert wave.stride(0) == 0
    cm = 0.9 * torch.rand((members, 5000), generator=g, device=cuda)
    idx = torch.randint(0, 6000, (members, k), generator=g, device=cuda)
    idx[:, ::5] = -1
    before = ops.LAUNCHES["fl_gains_at"]
    got = ops.fl_gains_at(wave, cm, idx)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fl_gains_at"] == before + 1
    assert torch.equal(got, fl_gains_at_plain(wave, cm, idx))
    for b in (0, members - 1):
        assert torch.equal(got[b], ops.fl_gains_at(sim, cm[b], idx[b]))


def test_seeded_draws_and_ladder_math_equal_on_cpu_and_card(cuda):
    """The threefry draws and the ladders' exp / log give the same bits on
    the card as on the CPU (the CPU's are the JAX package's,
    tests/test_torch_optimizers.py and test_torch_streaming.py)."""
    from repro_torch.core.optimizers import _threefry
    from repro_torch.core.optimizers._fp32 import exp32, log32

    for seed, step, n in ((0, 0, 1), (1, 7, 1000), (2**31 - 1, 4999, 50_000)):
        key = _threefry.fold_in(_threefry.prng_key(seed), step)
        assert torch.equal(_threefry.uniform(key, n, cuda).cpu(), _threefry.uniform(key, n, "cpu"))
        assert torch.equal(_threefry.step_bits(key, range(3), n, cuda).cpu(),
                           _threefry.step_bits(key, range(3), n, "cpu"))
        assert torch.equal(_threefry.fold_in_uniforms(key, n, cuda).cpu(),
                           _threefry.fold_in_uniforms(key, n, "cpu"))
    x = torch.empty(1 << 20).uniform_(-90, 90)
    assert torch.equal(exp32(x.to(cuda)).cpu(), exp32(x))
    m = torch.exp(torch.empty(1 << 20).uniform_(-80, 80))
    assert torch.equal(log32(m.to(cuda)).cpu(), log32(m))


@pytest.mark.parametrize("optimizer", ["SieveStreaming", "ThresholdGreedy", "StochasticGreedy",
                                       "LazierThanLazyGreedy"])
def test_remaining_optimizers_kernel_route_equals_plain_route(cuda, optimizer):
    """A small run of each on the FL kernel route (fl_gains / fl_gains_at,
    the sieves on a member-stride-0 wave) against the plain route: the same
    ids and n_evals, gains within the FL bar."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((6000, 32), generator=g, device=cuda)
    from repro_torch.core import FacilityLocation, create_kernel

    S = create_kernel(x, metric="cosine", use_pallas=True)
    kern = FacilityLocation.from_kernel(S, use_kernel=True)
    plain = FacilityLocation.from_kernel(S, use_kernel=False)
    opts = {"SieveStreaming": dict(epsilon=0.1, seed=0),
            "ThresholdGreedy": dict(epsilon=0.1, buffer_size=64),
            "StochasticGreedy": dict(seed=1), "LazierThanLazyGreedy": dict(seed=1)}[optimizer]
    ops.reset_launches()
    got = solve(SelectionSpec(kern, 40, optimizer, **opts))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fl_gains_at"] > 0
    before = dict(ops.LAUNCHES)
    want = solve(SelectionSpec(plain, 40, optimizer, **opts))
    assert dict(ops.LAUNCHES) == before
    a, b = result_to_numpy(got), result_to_numpy(want)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[2] == b[2]
    np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=1e-4)


def test_nccl_world_of_one_fl_wave_equals_sequential_on_the_card(cuda, tmp_path):
    """A world of 1 on NCCL: FL waves through solve(specs, mesh=mesh) on
    the kernel route, NaiveGreedy and LazyGreedy, every member bit-equal to
    its sequential solve, the sweeps launched on the card."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import make_mesh

    timeout = datetime.timedelta(seconds=120)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=timeout)
    try:
        mesh = make_mesh((1, 1), ("batch", "data"), timeout=timeout)
        gen = torch.Generator(device="cuda").manual_seed(11)
        n = KERNEL_MIN_N
        fns = [FacilityLocation.from_kernel(torch.rand((n, n), generator=gen, device="cuda"),
                                            use_kernel=None) for _ in range(2)]
        assert backend_name(fns[0]) == "cuda-fl"
        for opt in ("NaiveGreedy", "LazyGreedy"):
            specs = [SelectionSpec(f, b, opt) for f, b in zip(fns, (20, 12))]
            seq = [solve(s) for s in specs]
            ops.reset_launches()
            got = solve(specs, mesh=mesh)
            assert ops.LAUNCHES["fl_gains_at" if opt == "LazyGreedy" else "fl_gains"] > 0, opt
            for s, r, q in zip(specs, got, seq):
                _bits(r, q, f"{opt} budget {s.budget}")
    finally:
        dist.destroy_process_group()


def _nccl_world_of_one(tmp_path):
    import datetime

    import torch.distributed as dist

    from repro_torch.core import make_mesh

    timeout = datetime.timedelta(seconds=120)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=timeout)
    return make_mesh((1, 1), ("batch", "data"), timeout=timeout)


def test_nccl_mesh_server_waves_equal_sequential_on_the_card(cuda, tmp_path):
    """A world of 1 on NCCL: a mesh SelectionServer over FL, FB, SC and PSC
    requests at the kernel gate, NaiveGreedy and LazyGreedy; every answer
    bit-equal to its sequential solve, served on the mesh (no fallback),
    through the kernels."""
    import torch.distributed as dist

    from repro_torch.launch.serve import SelectionServer

    mesh = _nccl_world_of_one(tmp_path)
    try:
        gen = torch.Generator(device="cuda").manual_seed(12)
        n = KERNEL_MIN_N
        fns = [
            FacilityLocation.from_kernel(torch.rand((n, n), generator=gen, device="cuda"),
                                         use_kernel=None),
            FeatureBased.from_features(torch.rand((n, 64), generator=gen, device="cuda"),
                                       use_kernel=None),
            SetCover.from_cover((torch.rand((n, 64), generator=gen, device="cuda") < 0.1)
                                .float(), use_kernel=None),
            ProbabilisticSetCover.from_probs(
                0.5 * torch.rand((n, 64), generator=gen, device="cuda"), use_kernel=None),
        ]
        specs = [SelectionSpec(f, b, opt) for f in fns
                 for b, opt in ((20, "NaiveGreedy"), (12, "LazyGreedy"))]
        seq = [solve(s) for s in specs]
        server = SelectionServer(mesh=mesh)
        ops.reset_launches()
        got = server.select(specs)
        torch.cuda.synchronize()
        for name in ("fl_gains", "fl_gains_at", "fb_gains", "sc_gains", "psc_gains"):
            assert ops.LAUNCHES[name] > 0, name
        for s, r, q in zip(specs, got, seq):
            _bits(r.result, q, f"{type(s.fn).__name__} {s.optimizer.name}")
            assert r.degraded is None and r.backend != "torch"
        assert server.stats.summary()["fallbacks_total"] == 0
        assert server.mesh_stats["waves"] == server.stats.waves
        server.close()
    finally:
        dist.destroy_process_group()


def test_nccl_mesh_server_refuses_a_kernel_graph_cut(cuda, tmp_path):
    """A use_kernel=None GraphCut at n >= KERNEL_MIN_N resolves to its
    stateless kernel on the card, which the mesh refuses as the JAX package
    does: the wave fails typed before any plan and charges the mesh
    breaker; no answer is served."""
    import torch.distributed as dist

    from repro_torch.core import GraphCut
    from repro_torch.launch.serve import FlushError, SelectionServer

    mesh = _nccl_world_of_one(tmp_path)
    try:
        gen = torch.Generator(device="cuda").manual_seed(13)
        S = torch.rand((KERNEL_MIN_N, KERNEL_MIN_N), generator=gen, device="cuda")
        fn = GraphCut.from_kernel(S, lam=0.3, use_kernel=None)
        assert backend_name(fn) != "torch"
        server = SelectionServer(mesh=mesh)
        rid = server.submit(SelectionSpec(fn, 10))
        with pytest.raises(FlushError, match="use_kernel") as ei:
            server.flush()
        assert isinstance(ei.value.__cause__, ValueError)
        assert ei.value.failed_rids == [rid]
        assert server.breakers.get(("GraphCut", "mesh"))._failures == 1
        assert server.mesh_stats["waves"] == 0
        server.close()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("opt", ["NaiveGreedy", "LazyGreedy"])
def test_fl_kernel_padded_to_the_data_axis_is_bit_exact_on_the_card(cuda, opt):
    """An FL request of odd n at the kernel gate, padded with a zero column
    to a data axis of 2 as a mesh server pads it: its wave member, on the
    CUDA FL kernels, equals its unpadded sequential solve bit for bit."""
    from repro_torch.core import BatchedEngine
    from repro_torch.launch.coalesce import bucket_for, pad_function

    gen = torch.Generator(device="cuda").manual_seed(14)
    n = KERNEL_MIN_N + 1
    fn = FacilityLocation.from_kernel(torch.rand((n, n), generator=gen, device="cuda"),
                                      use_kernel=True)
    spec = SelectionSpec(fn, 40, opt)
    want = solve(spec)
    padded = pad_function(fn, bucket_for(fn, 2), n_multiple=2)
    assert padded.n == n + 1 and backend_name(padded) != "torch"
    valid = np.zeros((2, n + 1), bool)
    valid[:, :n] = True
    ops.reset_launches()
    got = BatchedEngine([padded, padded], valid=valid).run(
        [40, 0], spec.optimizer, stop_if_zero=spec.stop_if_zero,
        stop_if_negative=spec.stop_if_negative)[0]
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fl_gains" if opt == "NaiveGreedy" else "fl_gains_at"] > 0
    _bits(got, want, f"FL n {n} padded to {n + 1}, {opt}")


def test_training_launcher_on_the_card(cuda, tmp_path, capsys):
    """The training launcher at the reduced qwen3-0.6b on the card: a
    selection round over a pool of 4,096 (the kernel gate) runs the CUDA
    similarity and FL kernels, the losses are finite, the run resumes from
    its checkpoint; a bf16 TrainState on the card comes back from its
    checkpoint bit for bit, on the card."""
    import dataclasses

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import run
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    d = str(tmp_path / "ck")
    kw = dict(batch=16, seq=32, select_every=64, pool_factor=4, ckpt_dir=d, ckpt_every=3)
    ops.reset_launches()
    losses = run("qwen3-0.6b", steps=3, **kw)
    torch.cuda.synchronize()
    assert len(losses) == 3 and np.isfinite(losses).all()
    for name in ("similarity", "fl_gains", "fl_gains_at"):
        assert ops.LAUNCHES[name] > 0, name
    resumed = run("qwen3-0.6b", steps=5, **kw)
    assert len(resumed) == 2 and np.isfinite(resumed).all()
    assert "[ckpt] resumed from step 3" in capsys.readouterr().out

    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    state = init_train_state(cfg, seed=1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 32), device="cuda", dtype=torch.int32)}
    state, metrics = make_train_step(cfg)(state, batch)
    assert math.isfinite(float(metrics["loss"]))
    ckpt.save(str(tmp_path / "bf16"), 1, state)
    restored, _ = ckpt.restore(str(tmp_path / "bf16"), init_train_state(cfg, seed=2))
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and b.device.type == "cuda" and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


@pytest.mark.parametrize("arch", ["mamba2-370m", "deepseek-v2-236b", "whisper-small",
                                  "jamba-1.5-large-398b"])
def test_other_families_on_the_card(cuda, arch, tmp_path):
    """The moe (MLA), ssm, audio and hybrid families reduced, on the card:
    prefill of 40 tokens and a decode_step equal to a prefill of the
    extended tokens in fp32 (test_archs.py's 2e-2), one bf16 train step with
    finite loss and every gradient finite; mamba2 also through
    launch.train.run over a pool of 4,096 (the kernel gate: the CUDA
    similarity and FL sweeps), with a checkpoint and a resumed run."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import run
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.train.train_step import init_train_state, make_train_step, value_and_grad
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch).reduced()
    state = init_train_state(cfg, seed=1)
    batch = SyntheticTokens(cfg, 41, seed=2).batch(range(2))
    head = {**batch, "tokens": batch["tokens"][:, :40]}
    logits, caches = prefill(cfg, state.params, head, max_len=41)
    logits, _ = decode_step(cfg, state.params, caches, batch["tokens"][:, 40:], 40)
    ref, _ = prefill(cfg, state.params, batch)
    assert logits.is_cuda and torch.isfinite(logits).all()
    torch.testing.assert_close(logits[:, 0], ref[:, 0], rtol=2e-2, atol=2e-2)

    bf = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    state = init_train_state(bf, seed=1)
    train_batch = SyntheticTokens(bf, 32, seed=3).batch(range(4))
    _, grads = value_and_grad(bf, state.params, train_batch)
    assert all(torch.isfinite(g.float()).all() for g in tree_leaves(grads))
    state, metrics = make_train_step(bf)(state, train_batch)
    assert math.isfinite(float(metrics["loss"])) and math.isfinite(float(metrics["grad_norm"]))

    if arch == "mamba2-370m":
        kw = dict(batch=16, seq=32, select_every=64, pool_factor=4,
                  ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
        ops.reset_launches()
        losses = run(arch, steps=2, **kw)
        torch.cuda.synchronize()
        assert len(losses) == 2 and np.isfinite(losses).all()
        for name in ("similarity", "fl_gains", "fl_gains_at"):
            assert ops.LAUNCHES[name] > 0, name
        resumed = run(arch, steps=3, **kw)
        assert len(resumed) == 1 and np.isfinite(resumed).all()


@pytest.mark.parametrize("policy", ["fsdp", "dp"])
def test_nccl_world_of_one_sharded_steps_equal_the_unsharded_steps(cuda, tmp_path, policy):
    """Chip-smoke phase 17 (aa) at a reduced depth: qwen3-0.6b at its full
    width with 2 layers, three train steps on DTensors placed by
    ``param_shardings`` on an NCCL (1, 1) mesh under ``activation_sharding``
    equal the unsharded steps bit for bit: every loss and every leaf."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed.act_sharding import activation_sharding
    from repro_torch.distributed.sharding import (
        batch_specs, distribute, param_shardings, shardings_of,
    )
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import flatten_with_names

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2)
    batches = [SyntheticTokens(cfg, 128, seed=s).batch(range(4)) for s in range(3)]
    step = make_train_step(cfg)
    want = init_train_state(cfg, seed=0)
    want_losses = []
    for b in batches:
        want, m = step(want, b)
        want_losses.append(m["loss"])
    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh((1, 1))
        state = init_train_state(cfg, seed=0)
        state = distribute(state, param_shardings(state, mesh, policy))
        for b, want_loss in zip(batches, want_losses):
            b = distribute(b, shardings_of(b, batch_specs(b, mesh, policy=policy), mesh))
            with activation_sharding(mesh, policy=policy):
                state, m = step(state, b)
            assert torch.equal(m["loss"].full_tensor(), want_loss)
        ref = dict(flatten_with_names(want))
        for name, leaf in flatten_with_names(state):
            assert torch.equal(leaf.full_tensor(), ref[name]), name
    finally:
        dist.destroy_process_group()
