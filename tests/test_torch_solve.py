"""solve() of the port against the JAX package on the CPU: NaiveGreedy and
LazyGreedy over the same similarity must pick the same ids and count the
same n_evals, for every backend choice; plus the spec validation, the tie
rule and the backend decision table."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import OptimizerSpec as JOptimizerSpec
from repro.core import SelectionSpec as JSelectionSpec
from repro.core import create_kernel as jcreate_kernel
from repro.core import solve as jsolve
from repro_torch.common import first_argmax, masked_first_argmax
from repro_torch.core import (
    FacilityLocation,
    OptimizerSpec,
    SelectionSpec,
    backend_name,
    choose_backend,
    kernel_enabled,
    optimizer_names,
    solve,
)
from repro_torch.core.optimizers.backends import KERNEL_MIN_N
from repro_torch.core.optimizers.greedy import _screen_levels
from repro_torch.interop import facility_location_from_arrays, result_to_numpy

# gains are fp32 sums of at most a few hundred relu terms, in another order
# than XLA's; ids and n_evals must be equal
GAIN_TOL = dict(rtol=1e-5, atol=1e-5)
OPTIMIZERS = [
    ("NaiveGreedy", {}),
    ("LazyGreedy", {"screen_k": 1}),
    ("LazyGreedy", {"screen_k": 8}),
]
_JAX_CACHE: dict = {}


def _similarity(seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=(160, 12)).astype(np.float32)
    return np.asarray(jcreate_kernel(x, metric="cosine"))


def _jax_result(sim_key, sim, budget, optimizer, params, use_kernel, **stops):
    key = (sim_key, budget, optimizer, tuple(sorted(params.items())), use_kernel,
           tuple(sorted(stops.items())))
    if key not in _JAX_CACHE:
        jfn = JFacilityLocation.from_kernel(jnp.asarray(sim))
        res = jsolve(JSelectionSpec(jfn, budget, optimizer, use_kernel=use_kernel, **stops, **params))
        _JAX_CACHE[key] = (
            np.asarray(res.order), np.asarray(res.gains), int(res.n_evals), float(res.value)
        )
    return _JAX_CACHE[key]


def _assert_same(port, jax_res):
    order, gains, n_evals, value = result_to_numpy(port)
    jorder, jgains, jn_evals, jvalue = jax_res
    np.testing.assert_array_equal(order, jorder)
    assert n_evals == jn_evals
    np.testing.assert_allclose(gains, jgains, **GAIN_TOL)
    np.testing.assert_allclose(value, jvalue, **GAIN_TOL)


@pytest.mark.parametrize("use_kernel", [True, False, None])
@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_matches_jax(seed, optimizer, params, use_kernel):
    sim = _similarity(seed)
    fn = facility_location_from_arrays(sim, device="cpu")
    res = solve(SelectionSpec(fn, 20, optimizer, use_kernel=use_kernel, **params))
    _assert_same(res, _jax_result(seed, sim, 20, optimizer, params, use_kernel))


@pytest.mark.parametrize("stop_zero", [True, False])
@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_stop_rule_matches_jax(optimizer, params, stop_zero):
    """Only 6 columns carry similarity: the gains reach 0 after a few picks
    and stopIfZeroGain ends the selection with -1 padding."""
    rng = np.random.default_rng(7)
    sim = np.zeros((40, 30), np.float32)
    sim[:, :6] = rng.uniform(0, 1, size=(40, 6))
    fn = facility_location_from_arrays(sim, use_kernel=True, device="cpu")
    res = solve(SelectionSpec(fn, 12, optimizer, stopIfZeroGain=stop_zero, **params))
    _assert_same(res, _jax_result("zeros", sim, 12, optimizer, params, None,
                                  stopIfZeroGain=stop_zero))
    order = res.order.numpy()
    assert ((order < 0).any()) == stop_zero


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_tie_takes_the_first_index(optimizer, params, use_kernel):
    """Column 9 duplicates column 4, the best column: both engines pick 4,
    the first maximal index, as the JAX package does."""
    rng = np.random.default_rng(8)
    sim = rng.uniform(0, 0.5, size=(50, 20)).astype(np.float32)
    sim[:, 4] = 0.9
    sim[:, 9] = sim[:, 4]
    fn = facility_location_from_arrays(sim, device="cpu")
    res = solve(SelectionSpec(fn, 5, optimizer, use_kernel=use_kernel, **params))
    assert int(res.order[0]) == 4
    _assert_same(res, _jax_result("tie", sim, 5, optimizer, params, use_kernel))


def test_argmax_takes_the_first_maximum():
    x = torch.tensor([0.5, 2.0, -1.0, 2.0, 2.0])
    assert int(first_argmax(x)) == 1
    valid = torch.tensor([True, False, True, True, True])
    assert int(masked_first_argmax(x, valid)) == 3


def test_screen_levels_double_up_to_n():
    assert _screen_levels(10, 1) == ((0, 1), (1, 2), (2, 4), (4, 8), (8, 10))
    assert _screen_levels(5, 8) == ((0, 5),)


def test_result_as_list_drops_padding():
    sim = np.zeros((6, 5), np.float32)
    sim[:, 2] = 1.0
    res = solve(SelectionSpec(facility_location_from_arrays(sim, device="cpu"), 3))
    assert res.as_list() == [(2, 6.0)]


def _fn():
    return facility_location_from_arrays(np.ones((3, 4), np.float32), device="cpu")


def test_spec_validation_uses_the_jax_exception_types():
    cases = [
        (ValueError, lambda F, O, f: F(f, 2, "NoSuchGreedy")),
        (ValueError, lambda F, O, f: F(f, 0)),
        (TypeError, lambda F, O, f: F(f, 2, "LazyGreedy", screen_kk=3)),
        (TypeError, lambda F, O, f: F(f, 2, "LazyGreedy", screen_k=0)),
        (TypeError, lambda F, O, f: F(object(), 2)),
        (TypeError, lambda F, O, f: F(f, 2, O("NaiveGreedy"), screen_k=2)),
        (ValueError, lambda F, O, f: O("NoSuchGreedy")),
    ]
    sides = [
        (JSelectionSpec, JOptimizerSpec, JFacilityLocation.from_kernel(jnp.ones((3, 4)))),
        (SelectionSpec, OptimizerSpec, _fn()),
    ]
    for exc, build in cases:
        for spec_cls, opt_cls, fn in sides:
            with pytest.raises(exc):
                build(spec_cls, opt_cls, fn)


def test_spec_defaults_and_unported_options():
    fn = _fn()
    spec = SelectionSpec(fn, 3, "LazyGreedy")
    assert spec.optimizer.params == {"screen_k": 8}
    assert spec.stop_if_zero and spec.stop_if_negative and spec.use_kernel is None
    assert spec.resolved_fn() is fn
    assert SelectionSpec(fn, 3, use_kernel=True).resolved_fn().use_kernel is True
    assert optimizer_names() == ["LazyGreedy", "NaiveGreedy"]
    with pytest.raises(TypeError, match="serving slice"):
        SelectionSpec(fn, 3, deadline_s=1.0)
    for mode in ("sharded", "served", "async", "nonsense"):
        with pytest.raises(ValueError, match="mode"):
            solve(spec, mode=mode)
    # the batched route is ported: one spec through it equals its sequential solve
    one = solve(spec, mode="batched")
    seq = solve(spec)
    assert one.order.tolist() == seq.order.tolist() and int(one.n_evals) == int(seq.n_evals)
    assert torch.equal(one.gains, seq.gains.cpu())
    with pytest.raises(TypeError):
        solve([spec, "not a spec"])
    a, b = solve([spec, SelectionSpec(fn, 2)], mode="sequential")
    assert a.order.shape == (3,) and b.order.shape == (2,)
    # a list defaults to one batched wave, which refuses mixed optimizers, as
    # the JAX package does
    jfn = JFacilityLocation.from_kernel(jnp.ones((3, 4)))
    for spec_cls, f in ((JSelectionSpec, jfn), (SelectionSpec, fn)):
        solver = jsolve if spec_cls is JSelectionSpec else solve
        with pytest.raises(ValueError, match="served"):
            solver([spec_cls(f, 3, "LazyGreedy"), spec_cls(f, 2)])


def test_choose_backend_decision_table():
    n = KERNEL_MIN_N
    assert choose_backend(n, device="cuda") == "kernel"
    assert choose_backend(n, device=torch.device("cuda", 0)) == "kernel"
    assert choose_backend(n - 1, device="cuda") == "torch"
    assert choose_backend(10**6, device="cpu") == "torch"
    assert choose_backend(n, budget=n, device="cuda") == "torch"  # budget > n/4
    assert choose_backend(1024, device="cuda", matrix_free=True) == "kernel"
    # an explicit flag always wins
    assert kernel_enabled(True, 10, device="cpu") is True
    assert kernel_enabled(False, 10**6, device="cuda") is False
    assert kernel_enabled(None, 10**6, device="cuda") is True
    assert kernel_enabled(None, 10**6, device="cpu") is False


def test_backend_name_follows_the_flag_and_the_tensor_device():
    sim = torch.rand(8, KERNEL_MIN_N)
    assert backend_name(FacilityLocation.from_kernel(sim, use_kernel=None)) == "torch"
    assert backend_name(FacilityLocation.from_kernel(sim, use_kernel=True)) == "cuda-fl"
    assert backend_name(FacilityLocation.from_kernel(sim, use_kernel=False)) == "torch"
