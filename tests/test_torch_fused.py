"""The port's fused dot similarity + FL sweep against the JAX package on the
CPU: ``ops.fused_fl_sweep`` on CPU tensors (the plain version,
``fused_fl_sweep_plain``) against ``fused_fl_sweep_pallas`` in interpret
mode and ``fused_fl_sweep_ref``, in fp32 and bf16; its column-slice bit
identity; its agreement with the matrix-free FL sweep; and a
FacilityLocationMF selection replayed through it.

Inputs are numpy arrays from a seed, handed to both packages.  Bars: the
JAX package's own for this kernel (tests/test_kernels.py:115-137, 433-445):
rtol 1e-4 / atol 1e-3 in fp32, rtol 1e-3 / atol 5e-2 in bf16 (bf16 inputs
summed in another order).  The selection replay holds ids equal and gains
to the matrix-free bar, 2e-5 (tests/test_matrix_free.py:76).  The CUDA
kernel is held against the plain version on the card by
tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.kernels.fused_fl_sweep import fused_fl_sweep_pallas, fused_fl_sweep_ref
from repro_torch.common import NEG_INF
from repro_torch.core import FacilityLocationMF, SelectionSpec, solve
from repro_torch.kernels import ops
from repro_torch.kernels.flmf_gains import flmf_gains_plain
from repro_torch.kernels.fused_fl_sweep import fused_fl_sweep_plain

FUSED_SHAPES = [(40, 60, 16), (300, 700, 128), (256, 512, 300), (513, 1025, 80)]
# the widths at which the CUDA mainloop's load paths part (16-byte copies
# take fp32 rows with d % 4 == 0, bf16 rows with d % 8 == 0; a strip is
# 32 k), with u and n not multiples of the kernel's 128-row tile
RAGGED_D = [1, 3, 4, 13, 16, 17, 31, 33, 130]
RAGGED_UN = (129, 203)
F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=1e-3, atol=5e-2)
MF_TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(u, n, d, seed=0, cm_hi=3.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(u, d)).astype(np.float32)
    y = rng.normal(size=(n, d)).astype(np.float32)
    cm = rng.uniform(0, cm_hi, size=(u,)).astype(np.float32)
    return x, y, cm


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_plain_matches_pallas_and_ref(shape):
    u, n, d = shape
    x, y, cm = _inputs(u, n, d)
    got = ops.fused_fl_sweep(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(cm))
    assert got.dtype == torch.float32 and got.shape == (n,)
    pallas = fused_fl_sweep_pallas(x, y, cm, interpret=True, bu=128, bn=128, bk=64)
    ref = fused_fl_sweep_ref(jnp.asarray(x), jnp.asarray(y), jnp.asarray(cm))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_dtypes_match_pallas_and_ref(dtype):
    """tests/test_kernels.py:433's case: x (100, 96), y (90, 96); both
    packages round the same fp32 numpy to bf16 (round to nearest even)."""
    x, y, cm = _inputs(100, 90, 96, seed=1, cm_hi=2.0)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt, yt = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    xj, yj = jnp.asarray(x, jdt), jnp.asarray(y, jdt)
    np.testing.assert_array_equal(xt.float().numpy(), np.asarray(xj.astype(jnp.float32)))
    got = ops.fused_fl_sweep(xt, yt, torch.from_numpy(cm)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(fused_fl_sweep_pallas(xj, yj, jnp.asarray(cm), interpret=True)), **BF16_TOL)
    np.testing.assert_allclose(got, np.asarray(fused_fl_sweep_ref(xj, yj, jnp.asarray(cm))),
                               **BF16_TOL)


@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_matches_pallas_and_ref_at_ragged_widths(dtype, d):
    u, n = RAGGED_UN
    x, y, cm = _inputs(u, n, d, seed=100 + d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xj, yj, cmj = jnp.asarray(x, jdt), jnp.asarray(y, jdt), jnp.asarray(cm)
    got = ops.fused_fl_sweep(torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt),
                             torch.from_numpy(cm)).numpy()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    pallas = fused_fl_sweep_pallas(xj, yj, cmj, interpret=True, bu=128, bn=128, bk=64)
    np.testing.assert_allclose(got, np.asarray(pallas), **tol)
    np.testing.assert_allclose(got, np.asarray(fused_fl_sweep_ref(xj, yj, cmj)), **tol)


def test_fused_bf16_is_the_fp32_sweep_of_the_widened_values():
    """bf16 widens to fp32 exactly, so a bf16 sweep equals the fp32 sweep of
    the widened features bit for bit (the kernel's loader does the same)."""
    x, y, cm = _inputs(70, 600, 48, seed=2)
    xb, yb = torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16()
    cmt = torch.from_numpy(cm)
    for xa, ya in ((xb, yb), (xb, yb.float()), (xb.float(), yb)):
        assert torch.equal(ops.fused_fl_sweep(xa, ya, cmt),
                           ops.fused_fl_sweep(xb.float(), yb.float(), cmt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_column_slices_and_gathers_bit_identical(dtype):
    """fused(y)[cols] == fused(y[cols]) bit for bit: a column's value does
    not depend on where it sits."""
    x, y, cm = _inputs(37, 1300, 24, seed=3)
    xt, yt, cmt = torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype), torch.from_numpy(cm)
    full = ops.fused_fl_sweep(xt, yt, cmt)
    for lo, hi in ((0, 1), (5, 517), (512, 1024), (1000, 1300)):
        assert torch.equal(ops.fused_fl_sweep(xt, yt[lo:hi].contiguous(), cmt), full[lo:hi])
    idx = torch.from_numpy(np.random.default_rng(4).integers(0, 1300, size=333))
    assert torch.equal(ops.fused_fl_sweep(xt, yt[idx].contiguous(), cmt), full[idx])


def test_fused_equals_the_matrix_free_dot_sweep():
    """The same function as flmf_gains(metric="dot"): the plain versions
    multiply the same fixed-width tiles and agree bit for bit on the CPU."""
    x, y, cm = _inputs(129, 777, 33, seed=5)
    xt, yt, cmt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(cm)
    want = flmf_gains_plain(xt, yt, (xt * xt).sum(1), (yt * yt).sum(1), cmt, "dot")
    assert torch.equal(ops.fused_fl_sweep(xt, yt, cmt), want)
    assert torch.equal(fused_fl_sweep_plain(xt, yt, cmt), want)


def test_fused_edge_shapes():
    x, y, cm = _inputs(5, 3, 4)
    xt, yt, cmt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(cm)
    assert ops.fused_fl_sweep(xt, yt[:0], cmt).shape == (0,)
    assert torch.equal(ops.fused_fl_sweep(xt[:0], yt, cmt[:0]), torch.zeros(3))
    # a row of curmax 3e38 (the JAX wrapper's pad value) adds exactly 0
    pad = torch.cat([xt, torch.ones((1, 4))]), torch.cat([cmt, torch.tensor([3e38])])
    assert torch.equal(ops.fused_fl_sweep(pad[0], yt, pad[1]), ops.fused_fl_sweep(xt, yt, cmt))


def test_fused_wrapper_checks_its_inputs():
    x, y, cm = torch.rand((8, 4)), torch.rand((6, 4)), torch.rand(8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fused_fl_sweep(x.double(), y, cm)
    with pytest.raises(TypeError, match="float32"):
        ops.fused_fl_sweep(x, y, cm.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_fl_sweep(x, torch.rand((4, 6)).T, cm)
    with pytest.raises(ValueError, match="widths"):
        ops.fused_fl_sweep(x, torch.rand((6, 5)), cm)
    with pytest.raises(ValueError, match="does not match"):
        ops.fused_fl_sweep(x, y, torch.rand(7))
    with pytest.raises(TypeError, match="torch.Tensor"):
        ops.fused_fl_sweep(x.numpy(), y, cm)


def test_fused_replays_a_matrix_free_selection_like_jax():
    """chip_smoke.py phase 9 (i) at a small size: FacilityLocationMF (dot)
    NaiveGreedy in both packages; at every state of the port's run the fused
    sweep's first argmax over unselected candidates is the JAX package's
    pick, its gains equal the FLMF sweep's within the matrix-free bar, and
    the picks' gains equal the JAX gains within it."""
    rng = np.random.default_rng(6)
    feats = np.maximum(rng.normal(size=(400, 32)), 0).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    x, budget = feats[::16].copy(), 12
    jfn = J.FacilityLocationMF.from_features(jnp.asarray(x), jnp.asarray(feats), metric="dot")
    jres = J.solve(J.SelectionSpec(jfn, budget, "NaiveGreedy"))
    fn = FacilityLocationMF.from_features(x, feats, metric="dot", device="cpu")
    res = solve(SelectionSpec(fn, budget, "NaiveGreedy"))
    np.testing.assert_array_equal(res.order.numpy(), np.asarray(jres.order))
    src, state = fn.src, fn.init_state()
    selected = torch.zeros(fn.n, dtype=torch.bool)
    for t, j in enumerate(np.asarray(jres.order)):
        g = ops.fused_fl_sweep(src.x, src.y, state.curmax)
        np.testing.assert_allclose(g.numpy(), fn.gains(state).numpy(), **MF_TOL)
        assert int(torch.argmax(torch.where(selected, NEG_INF, g))) == j
        np.testing.assert_allclose(float(g[j]), float(np.asarray(jres.gains)[t]), **MF_TOL)
        state, selected[j] = fn.update(state, int(j)), True
