"""create_kernel and FacilityLocation of the port against the JAX package,
on the CPU: the same numpy inputs go to both, and state crosses over as
numpy arrays through repro_torch.interop."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import create_kernel as jcreate_kernel
from repro_torch.common import NEG_INF, mask_from_indices
from repro_torch.core import FacilityLocation, create_kernel, sparsify_topk
from repro_torch.interop import facility_location_from_arrays, fl_state_from_arrays

METRICS = ["dot", "cosine", "euclidean", "rbf"]
# fp32 products summed in another order; euclidean / rbf go through the
# cancellation-prone xx + yy - 2<x,y> (the JAX package's own bars)
SIM_TOL = {
    "dot": (1e-4, 1e-3),
    "cosine": (1e-4, 1e-3),
    "euclidean": (1e-3, 5e-2),
    "rbf": (1e-3, 5e-2),
}
# fp32 sums of at most a few hundred relu terms, in another order than XLA's
FL_TOL = dict(rtol=1e-5, atol=1e-5)


def _points(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_create_kernel_dense_matches_jax(metric, use_pallas):
    x, y = _points(0, 60, 10), _points(1, 45, 10)
    rtol, atol = SIM_TOL[metric]
    for args in ((x,), (x, y)):
        got = create_kernel(*args, metric=metric, use_pallas=use_pallas, device="cpu")
        want = np.asarray(jcreate_kernel(*args, metric=metric))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("metric", METRICS)
def test_create_kernel_sparse_matches_jax(metric):
    x = _points(2, 50, 6)
    got = create_kernel(x, metric=metric, mode="sparse", num_neighbors=5, device="cpu")
    want = np.asarray(jcreate_kernel(x, metric=metric, mode="sparse", num_neighbors=5))
    rtol, atol = SIM_TOL[metric]
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    assert ((got.numpy() != 0).sum(1) == (want != 0).sum(1)).all()


def test_create_kernel_options_and_errors():
    x = _points(3, 20, 4)
    got = create_kernel(x, metric="rbf", rbf_sigma=0.7, device="cpu").numpy()
    want = np.asarray(jcreate_kernel(x, metric="rbf", rbf_sigma=0.7))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-2)
    with pytest.raises(ValueError, match="metric"):
        create_kernel(x, metric="hamming", device="cpu")
    with pytest.raises(ValueError, match="num_neighbors"):
        create_kernel(x, mode="sparse", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        create_kernel(x, mode="clustered", device="cpu")
    # a tensor keeps its device (and becomes fp32)
    t = torch.from_numpy(x).double()
    assert create_kernel(t).device.type == "cpu"
    s = create_kernel(t, metric="dot")
    assert s.dtype == torch.float32
    top = sparsify_topk(s, 3)
    assert ((top != 0).sum(1) >= 3).all()


def _jax_and_port(seed, u=70, n=90, use_kernel=False):
    rng = np.random.default_rng(seed)
    sim = rng.uniform(0, 1, size=(u, n)).astype(np.float32)
    jfn = JFacilityLocation.from_kernel(jnp.asarray(sim), use_kernel=use_kernel)
    fn = facility_location_from_arrays(np.asarray(jfn.sim), use_kernel=use_kernel, device="cpu")
    return jfn, fn


@pytest.mark.parametrize("use_kernel", [False, True])
def test_facility_location_protocol_matches_jax(use_kernel):
    jfn, fn = _jax_and_port(4, use_kernel=use_kernel)
    assert fn.n == jfn.n == 90
    jstate = jfn.init_state()
    for step, j in enumerate([7, 3, 51, 3, 88]):
        state = fl_state_from_arrays(np.asarray(jstate.curmax), device="cpu")
        np.testing.assert_allclose(
            fn.gains(state).numpy(), np.asarray(jfn.gains(jstate)), **FL_TOL
        )
        idx = np.array([0, -1, j, 89, -3, j], np.int32)
        got = fn.gains_at(state, torch.from_numpy(idx)).numpy()
        want = np.asarray(jfn.gains_at(jstate, jnp.asarray(idx)))
        np.testing.assert_allclose(got, want, **FL_TOL)
        assert (got[idx < 0] == np.float32(NEG_INF)).all()
        np.testing.assert_allclose(
            float(fn.evaluate_state(state)), float(jfn.evaluate_state(jstate)), **FL_TOL
        )
        jstate = jfn.update(jstate, j)
        new = fn.update(state, torch.tensor(j))
        np.testing.assert_array_equal(new.curmax.numpy(), np.asarray(jstate.curmax))
        assert new.n_rows == jstate.n_rows == 70


def test_facility_location_evaluate_matches_jax():
    jfn, fn = _jax_and_port(5)
    rng = np.random.default_rng(5)
    for size in (0, 1, 4, 30):
        mask = np.zeros(fn.n, bool)
        mask[rng.choice(fn.n, size, replace=False)] = True
        np.testing.assert_allclose(
            float(fn.evaluate(torch.from_numpy(mask))),
            float(jfn.evaluate(jnp.asarray(mask))),
            **FL_TOL,
        )
    idx = [4, -1, 17, 4]
    np.testing.assert_allclose(
        float(fn.evaluate_indices(idx)), float(jfn.evaluate_indices(jnp.asarray(idx))), **FL_TOL
    )
    mask = np.zeros(fn.n, bool)
    mask[[1, 2]] = True
    np.testing.assert_allclose(
        float(fn.marginal_gain(torch.from_numpy(mask), 9)),
        float(jfn.marginal_gain(jnp.asarray(mask), 9)),
        **FL_TOL,
    )


def test_mask_from_indices_drops_padding():
    m = mask_from_indices([3, -1, 0, 3, 9], 5)
    assert m.tolist() == [True, False, False, True, False]


def test_from_kernel_keeps_tensor_device_and_state_matches_gains():
    sim = torch.rand(12, 9)
    fn = FacilityLocation.from_kernel(sim)
    assert fn.sim.device.type == "cpu" and fn.n == 9 and fn.use_kernel is False
    state = fn.init_state()
    # f(A) telescopes: the state's value equals f evaluated from scratch
    for j in (2, 5, 2):
        state = fn.update(state, j)
    assert torch.allclose(fn.evaluate_state(state), fn.evaluate_indices([2, 5]))
