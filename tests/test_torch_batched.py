"""The port's batched engine against its own sequential solves and the JAX
package's, on the CPU.

Each wave member is held two ways:
- bit for bit against the port's own sequential solve: ids, gains,
  ``n_evals`` and the value;
- against the JAX package's *sequential* result over the same numpy arrays:
  ids and ``n_evals`` equal, gains within ROADMAP's bars (1e-5; 1e-4 for
  GraphCut and FeatureBased; 2e-5 for the matrix-free families).  The JAX
  package's own batched gains can part from its sequential ones by an ulp
  (FeatureBased), so its batched route is not the yardstick.

Ported from tests/test_batched.py (the engine, padding, reuse, rejections
and the every-family property) and the batched cases of tests/test_spec.py.
On the CPU the kernel wrappers run their plain versions; the FL wave's one
call per step is held here through the wrapper's arguments.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import FacilityLocationMF as JFacilityLocationMF
from repro.core import GraphCutMF as JGraphCutMF
from repro.core import SelectionSpec as JSelectionSpec
from repro.core import create_kernel as jcreate_kernel
from repro.core import knn_from_features as jknn_from_features
from repro.core import solve as jsolve
from repro.launch.serve import _random_function
from repro_torch.core import (
    BatchedEngine,
    FacilityLocation,
    FacilityLocationMF,
    GraphCutMF,
    OptimizerSpec,
    SelectionSpec,
    batched_maximize,
    knn_from_features,
    lazy_greedy,
    naive_greedy,
    register_optimizer,
    solve,
    stack_functions,
    wave_capable_names,
)
from repro_torch.core.optimizers import spec as spec_module
from repro_torch.core.optimizers.backends import full_sweep_wave, partial_sweep_wave
from repro_torch.core.optimizers.batched import member
from repro_torch.interop import (
    disparity_min_from_arrays,
    disparity_sum_from_arrays,
    facility_location_from_arrays,
    feature_based_from_arrays,
    flqmi_from_arrays,
    flvmi_from_arrays,
    gcmi_from_arrays,
    graph_cut_from_arrays,
    log_det_from_arrays,
    probabilistic_set_cover_from_arrays,
    result_to_numpy,
    set_cover_from_arrays,
)
from repro_torch.kernels import ops

CPU = "cpu"
N = 24


def _same(a, b, what=""):
    """Bit identity of two port results (ids, gains, n_evals, value)."""
    ra, rb = result_to_numpy(a), result_to_numpy(b)
    np.testing.assert_array_equal(ra[0], rb[0], err_msg=what)
    np.testing.assert_array_equal(ra[1].view(np.int32), rb[1].view(np.int32), err_msg=what)
    assert ra[2] == rb[2], (what, ra[2], rb[2])
    assert np.float32(ra[3]).view(np.int32) == np.float32(rb[3]).view(np.int32), what


def _near_ref(port, jres, tol, what=""):
    """Ids and n_evals equal to a JAX result, gains within ``tol``."""
    order, gains, n_evals, _ = result_to_numpy(port)
    np.testing.assert_array_equal(order, np.asarray(jres.order), err_msg=what)
    assert n_evals == int(jres.n_evals), (what, n_evals, int(jres.n_evals))
    np.testing.assert_allclose(gains, np.asarray(jres.gains), rtol=tol, atol=tol, err_msg=what)


def _fl_pair(rng, n=N):
    """(port FL, JAX FL) over the same euclidean kernel."""
    x = rng.normal(size=(n, 5)).astype(np.float32)
    S = np.asarray(jcreate_kernel(x, metric="euclidean"))
    return facility_location_from_arrays(S, device=CPU), JFacilityLocation.from_kernel(S)


# -- the engine: tests/test_batched.py:108-254 ---------------------------------


@pytest.mark.parametrize("optimizer", ["NaiveGreedy", "LazyGreedy"])
def test_batched_matches_sequential_loop(optimizer):
    """B = 8 instances, mixed budgets: every member equals its sequential
    solve bit for bit and the JAX package's sequential solve."""
    rng = np.random.default_rng(0)
    pairs = [_fl_pair(rng) for _ in range(8)]
    budgets = [5, 3, 7, 5, 2, 6, 4, 5]
    single = {"NaiveGreedy": naive_greedy, "LazyGreedy": lazy_greedy}[optimizer]
    with pytest.warns(DeprecationWarning):
        batched = batched_maximize([p for p, _ in pairs], budgets, optimizer=optimizer,
                                   return_result=True)
    assert len(batched) == 8
    for (fn, jfn), b, res in zip(pairs, budgets, batched):
        _same(single(fn, b), res, optimizer)
        _near_ref(res, jsolve(JSelectionSpec(jfn, b, optimizer)), 1e-5, optimizer)


def test_batched_naive_eval_accounting_exact():
    """n_evals is exactly (steps taken) * n for the naive engine."""
    rng = np.random.default_rng(1)
    fns = [_fl_pair(rng)[0] for _ in range(4)]
    budgets = [3, 5, 1, 4]
    res = BatchedEngine(fns).run(budgets)
    for r, b in zip(res, budgets):
        steps = int((r.order >= 0).sum())
        assert steps == b  # monotone fn, budget < n: never stops early
        assert int(r.n_evals) == steps * N


@pytest.mark.parametrize("optimizer", ["NaiveGreedy", "LazyGreedy"])
def test_batched_valid_mask_padding(optimizer):
    """Zero-padded instances + a valid mask == the unpadded instance, bit
    for bit (ids, gains, n_evals), and the JAX package's unpadded solve."""
    rng = np.random.default_rng(2)
    n_small, n_pad = 20, 30
    x = rng.normal(size=(n_small, 6)).astype(np.float32)
    S = np.asarray(jcreate_kernel(x, metric="euclidean"))
    Sp = np.zeros((n_pad, n_pad), np.float32)
    Sp[:n_small, :n_small] = S
    for use_kernel in (False, True):
        fn_small = facility_location_from_arrays(S, use_kernel, device=CPU)
        fn_pad = facility_location_from_arrays(Sp, use_kernel, device=CPU)
        valid = np.zeros((4, n_pad), bool)
        valid[:, :n_small] = True
        res = BatchedEngine([fn_pad] * 4, valid=valid).run(5, optimizer)
        seq = solve(SelectionSpec(fn_small, 5, optimizer))
        jres = jsolve(JSelectionSpec(JFacilityLocation.from_kernel(S), 5, optimizer))
        for r in res:
            _same(seq, r, f"{optimizer} use_kernel={use_kernel}")
            _near_ref(r, jres, 1e-5, optimizer)


def test_batched_lazy_never_selects_padding():
    """With fewer valid candidates than screen_k and stopping off, the lazy
    screen's sorted order spills into padded candidates: they stay masked
    and are never selected."""
    rng = np.random.default_rng(3)
    n_valid, n_pad = 4, 16
    x = rng.normal(size=(n_valid, 4)).astype(np.float32)
    S = np.asarray(jcreate_kernel(x, metric="euclidean"))
    Sp = np.zeros((n_pad, n_pad), np.float32)
    Sp[:n_valid, :n_valid] = S
    valid = np.zeros((2, n_pad), bool)
    valid[:, :n_valid] = True
    with pytest.warns(DeprecationWarning):
        res = batched_maximize(
            [facility_location_from_arrays(Sp, device=CPU)] * 2, 10, optimizer="LazyGreedy",
            valid=valid, return_result=True, stopIfZeroGain=False, stopIfNegativeGain=False,
        )
    for r in res:
        order = r.order.numpy()
        chosen = order[order >= 0]
        assert (chosen < n_valid).all(), order
        assert len(set(chosen[:n_valid].tolist())) == n_valid, order


def test_batched_engine_reuse():
    """A resident engine answers repeated queries consistently and takes
    per-call budgets; the deprecated maximize() shim warns once."""
    rng = np.random.default_rng(4)
    engine = BatchedEngine([_fl_pair(rng)[0] for _ in range(3)])
    first = engine.run(4)
    again = engine.run(4)
    for a, b in zip(first, again):
        _same(a, b)
    shorter = engine.run(2)
    for a, s in zip(first, shorter):
        assert a.order[:2].tolist() == s.order.tolist()
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        lists = engine.maximize(4)
    assert sum(issubclass(w.category, DeprecationWarning) for w in record) == 1
    assert lists == [r.as_list() for r in first]
    with pytest.raises(ValueError, match="max_budget"):
        engine.run(4, max_budget=3)
    for r in engine.run([4, 2, 3], max_budget=6):  # a higher loop bound changes nothing
        assert r.order.shape[0] in (4, 2, 3)


def test_batched_rejects_mixed_families_and_shapes():
    rng = np.random.default_rng(5)
    fl = _fl_pair(rng, N)[0]
    x = rng.normal(size=(N, 5)).astype(np.float32)
    gc = graph_cut_from_arrays(
        np.asarray(jcreate_kernel(x)), np.asarray(jcreate_kernel(x)).sum(0), 0.3, device=CPU
    )
    with pytest.raises(ValueError, match="distinct structures"):
        BatchedEngine([fl, gc])
    with pytest.raises(ValueError, match="distinct structures"):  # n is a static field
        BatchedEngine([fl, _fl_pair(rng, N + 1)[0]])
    taller = facility_location_from_arrays(np.ones((N + 3, N), np.float32), device=CPU)
    with pytest.raises(ValueError, match="leaf shapes differ"):
        BatchedEngine([fl, taller])
    with pytest.raises(ValueError, match="budget list"):
        BatchedEngine([fl, fl]).run([3, 4, 5])
    with pytest.raises(ValueError, match="valid mask"):
        BatchedEngine([fl, fl], valid=np.ones((2, N + 1), bool))
    with pytest.raises(TypeError, match="make_mesh"):  # a mesh of the sharded engine
        BatchedEngine([fl], mesh=object())
    with pytest.raises(ValueError, match="at least one"):
        BatchedEngine([])
    # a spec's use_kernel is part of the function's static fields
    specs = [SelectionSpec(fl, 3, use_kernel=True), SelectionSpec(fl, 3, use_kernel=False)]
    with pytest.raises(ValueError, match="distinct structures"):
        solve(specs, mode="batched")


# -- stacking and the one wave launch -----------------------------------------


def test_stack_functions_member_views_share_the_stacked_tensors():
    rng = np.random.default_rng(6)
    fns = [_fl_pair(rng, 37)[0] for _ in range(3)]
    stacked = stack_functions(fns)
    assert stacked.sim.shape == (3, 37, 37)
    for b, fn in enumerate(fns):
        m = member(stacked, b)
        assert m.sim.is_contiguous() and torch.equal(m.sim, fn.sim)
        assert m.sim.untyped_storage().data_ptr() == stacked.sim.untyped_storage().data_ptr()
        # each member starts on a 512-byte slab, as a fresh allocation does
        assert (m.sim.data_ptr() - stacked.sim.data_ptr()) % 512 == 0
        assert m.n == fn.n and m.use_kernel == fn.use_kernel
    with pytest.raises(ValueError, match="at least one"):
        stack_functions([])


def test_fl_wave_sweeps_every_member_in_one_call(monkeypatch):
    """A use_kernel FL wave reaches ops.fl_gains / fl_gains_at once per
    sweep, with the engine's stacked (B, u, n) tensor, and each row equals
    the member's own sweep bit for bit."""
    rng = np.random.default_rng(7)
    fns = [_fl_pair(rng, 150)[0] for _ in range(3)]
    fns = [FacilityLocation(sim=f.sim, n=f.n, use_kernel=True) for f in fns]
    engine = BatchedEngine(fns)
    calls = []
    for name in ("fl_gains", "fl_gains_at"):
        orig = getattr(ops, name)

        def counted(*args, _orig=orig, _name=name):
            calls.append((_name, tuple(args[0].shape)))
            return _orig(*args)

        monkeypatch.setattr(ops, name, counted)
    states = [f.init_state() for f in engine.members]
    states = [f.update(s, torch.tensor([b])) for b, (f, s) in enumerate(zip(engine.members, states))]
    full = full_sweep_wave(engine.members, states)
    idx = torch.tensor([[3, -1, 7, 7], [0, 149, 2, 5], [9, 9, 9, 1]])
    part = partial_sweep_wave(engine.members, states, idx)
    assert calls == [("fl_gains", (3, 150, 150)), ("fl_gains_at", (3, 150, 150))]
    for b, (f, s) in enumerate(zip(fns, states)):
        assert torch.equal(full[b], f.gains(s))
        want = torch.where(idx[b] < 0, torch.tensor(-1e30), f.gains(s)[idx[b].clamp(min=0)])
        assert torch.equal(part[b], want)
    calls.clear()
    r_naive = engine.run([4, 2, 3])
    assert [c for c, _ in calls] == ["fl_gains"] * 4  # one per step, B = 3
    for f, b, r in zip(fns, [4, 2, 3], r_naive):
        _same(naive_greedy(f, b), r)


# -- every ported family in a wave: tests/test_batched.py:260-292 -------------

# (kind, gain bar against the JAX package)
FAMILIES = [
    ("fl", 1e-5), ("fl_kernel", 1e-5), ("gc", 1e-4), ("gc_kernel", 1e-4),
    ("fb", 1e-4), ("fb_kernel", 1e-4), ("sc", 1e-5), ("sc_kernel", 1e-5),
    ("psc", 1e-5), ("psc_kernel", 1e-5), ("dsum", 1e-5), ("dsum_kernel", 1e-5),
    ("dmin", 1e-5), ("dmin_kernel", 1e-5), ("flqmi", 1e-5), ("flvmi", 1e-5),
    ("gcmi", 1e-5), ("logdet", 1e-5), ("flmf", 2e-5), ("flmf_kernel", 2e-5),
    ("gcmf", 2e-5), ("gcmf_kernel", 2e-5), ("flmf_knn", 1e-5),
]


def _servable(kind, rng, n=64):
    """(port function, JAX function) of one family over the same arrays,
    shaped as tests/test_batched.py's _servable: head-heavy gains."""
    base = kind.removesuffix("_kernel")
    uk = kind.endswith("_kernel")
    if base in ("flmf", "gcmf", "flmf_knn"):
        x = rng.normal(size=(n, 8)).astype(np.float32)
        if base == "flmf":
            return (FacilityLocationMF.from_features(x, metric="cosine", use_kernel=uk, device=CPU),
                    JFacilityLocationMF.from_features(x, metric="cosine"))
        if base == "gcmf":
            return (GraphCutMF.from_features(x, lam=0.4, metric="cosine", use_kernel=uk, device=CPU),
                    JGraphCutMF.from_features(x, lam=0.4, metric="cosine"))
        jsrc = jknn_from_features(x, 6, metric="rbf")
        return (FacilityLocationMF.from_knn(np.asarray(jsrc.indices), np.asarray(jsrc.weights),
                                            device=CPU),
                JFacilityLocationMF.from_knn(jsrc.indices, jsrc.weights))
    if base == "sc":
        from repro.core import SetCover as JSetCover

        cover = rng.integers(0, 2, size=(n, 96)).astype(np.float32)
        w = rng.uniform(0.5, 2.0, 96).astype(np.float32)
        scale = (0.8 ** np.arange(n))[rng.permutation(n)].astype(np.float32)
        j = JSetCover.from_cover(cover * scale[:, None], w)
        return set_cover_from_arrays(np.asarray(j.cover), np.asarray(j.w), uk, CPU), j
    if base == "psc":
        from repro.core import ProbabilisticSetCover as JPSC

        probs = rng.uniform(0, 0.9, size=(n, 24)).astype(np.float32)
        scale = (0.75 ** np.arange(n))[rng.permutation(n)].astype(np.float32)
        j = JPSC.from_probs(probs * scale[:, None])
        return probabilistic_set_cover_from_arrays(np.asarray(j.log_miss), np.asarray(j.w), uk,
                                                   CPU), j
    if base == "flvmi":
        from repro.core import FLVMI

        x = rng.normal(size=(n, 8)).astype(np.float32)
        q = rng.normal(size=(5, 8)).astype(np.float32)
        j = FLVMI.build(np.asarray(jcreate_kernel(x, metric="euclidean")),
                        np.asarray(jcreate_kernel(x, q, metric="euclidean")))
        return flvmi_from_arrays(np.asarray(j.sim), np.asarray(j.qmax), CPU), j
    j = _random_function(base, n, rng)

    def a(name):
        return np.asarray(getattr(j, name))

    if base == "fl":
        return facility_location_from_arrays(a("sim"), uk, CPU), j
    if base == "gc":
        return graph_cut_from_arrays(a("sim_ground"), a("total"), a("lam"), uk, CPU), j
    if base == "fb":
        return feature_based_from_arrays(a("feats"), a("w"), j.concave, uk, CPU), j
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


@pytest.mark.parametrize("kind,tol", FAMILIES, ids=[k for k, _ in FAMILIES])
def test_batched_every_family_bit_identical(kind, tol):
    """Per family, three members with the reference property's seed and
    budgets: (a) batched LazyGreedy and NaiveGreedy equal the port's
    sequential solves bit for bit, (b) the JAX package's sequential solves
    within the family's bar, (c) batched LazyGreedy evaluates no more than
    batched NaiveGreedy on these head-heavy gains."""
    rng = np.random.default_rng(7)
    stop = not kind.startswith(("dsum", "dmin"))  # dispersion: empty-set gain is 0
    pairs = [_servable(kind, rng) for _ in range(3)]
    budgets = [12, 8, 10]
    kw = dict(stopIfZeroGain=stop, stopIfNegativeGain=stop)
    out = {}
    for optimizer in ("LazyGreedy", "NaiveGreedy"):
        specs = [SelectionSpec(p, b, optimizer, **kw) for (p, _), b in zip(pairs, budgets)]
        out[optimizer] = solve(specs)  # a list defaults to the batched route
        for (p, j), s, got in zip(pairs, specs, out[optimizer]):
            _same(solve(s), got, f"{kind} {optimizer}")
            _near_ref(got, jsolve(JSelectionSpec(j, s.budget, optimizer, **kw)), tol,
                      f"{kind} {optimizer}")
    for rl, rn in zip(out["LazyGreedy"], out["NaiveGreedy"]):
        assert int(rl.n_evals) <= int(rn.n_evals), kind


# -- solve(): tests/test_spec.py:266-330, 382-389 -----------------------------


def test_solve_single_vs_batched_bit_identical():
    rng = np.random.default_rng(8)
    spec = SelectionSpec(_fl_pair(rng, 32)[0], 4, "LazyGreedy", screen_k=6)
    seq = solve(spec)
    _same(seq, lazy_greedy(spec.fn, 4, 6))  # sequential == the raw optimizer
    for r in solve([spec, spec], mode="batched"):
        _same(seq, r)
    _same(seq, solve([spec])[0])  # a list of one rides the batched route


def test_solve_sequential_list_and_empty():
    rng = np.random.default_rng(9)
    specs = [SelectionSpec(_fl_pair(rng, 16)[0], b) for b in (2, 3)]
    for s, r in zip(specs, solve(specs, mode="sequential")):
        _same(r, naive_greedy(s.fn, s.budget))
    assert solve([], mode="batched") == []
    assert solve([]) == []


def test_solve_mode_validation():
    spec = SelectionSpec(_fl_pair(np.random.default_rng(10), 16)[0], 3)
    with pytest.raises(ValueError, match="unknown mode"):
        solve(spec, mode="warp")
    with pytest.raises(ValueError, match="mesh"):
        solve([spec], mode="sharded")
    with pytest.raises(TypeError, match="make_mesh"):
        solve([spec], mesh=object())
    # the served and async routes are ported: one spec through each (and
    # through a server of the caller's) equals its sequential solve
    from repro_torch.launch.serve import SelectionServer

    seq = solve(spec)
    for mode, server in (("served", None), ("async", None), ("served", SelectionServer())):
        _same(solve([spec], mode=mode, server=server)[0], seq, mode)
    with pytest.raises(TypeError, match="make_mesh"):  # serving on a mesh
        solve([spec], mode="served", mesh=object())
    with pytest.raises(TypeError, match="SelectionSpec"):
        solve([spec, "nope"])


def test_solve_batched_rejects_mixed_static_specs():
    fn = _fl_pair(np.random.default_rng(11), 16)[0]
    with pytest.raises(ValueError, match="served"):
        solve([SelectionSpec(fn, 3, "NaiveGreedy"), SelectionSpec(fn, 3, "LazyGreedy")],
              mode="batched")
    with pytest.raises(ValueError, match="served"):
        solve([SelectionSpec(fn, 3), SelectionSpec(fn, 3, stopIfZeroGain=False)])


def test_solve_batched_rejects_unbatchable_optimizer():
    """An optimizer registered without a batched hook is refused by the
    batched route, naming the batched-capable set, and runs sequentially."""
    fn = _fl_pair(np.random.default_rng(12), 16)[0]
    register_optimizer("SequentialOnlyGreedy", lambda f, b, z, ng: naive_greedy(f, b, z, ng))
    try:
        assert "SequentialOnlyGreedy" not in wave_capable_names()
        assert wave_capable_names() == [
            "LazyGreedy", "NaiveGreedy", "SieveStreaming", "ThresholdGreedy"
        ]
        spec = SelectionSpec(fn, 3, "SequentialOnlyGreedy")
        with pytest.raises(ValueError, match=r"batched-capable optimizers: \['LazyGreedy'"):
            solve([spec], mode="batched")
        with pytest.raises(ValueError, match="batched-capable"):
            BatchedEngine([fn]).run(3, OptimizerSpec("SequentialOnlyGreedy"))
        _same(solve(spec), naive_greedy(fn, 3))
    finally:
        del spec_module._OPTIMIZERS["SequentialOnlyGreedy"]
    assert "SequentialOnlyGreedy" not in spec_module.optimizer_names()


def test_batched_maximize_shim_warns_once_and_delegates():
    rng = np.random.default_rng(13)
    fns = [_fl_pair(rng, 16)[0] for _ in range(3)]
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        out = batched_maximize(fns, 3, return_result=True)
    msgs = [w for w in record if issubclass(w.category, DeprecationWarning)]
    assert len(msgs) == 1 and "solve" in str(msgs[0].message)
    for a, b in zip(out, solve([SelectionSpec(f, 3) for f in fns], mode="batched")):
        _same(a, b)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert batched_maximize([], 3) == []
        with pytest.raises(TypeError, match="stopIfZeroGian"):
            batched_maximize(fns, 3, stopIfZeroGian=False)


def test_batched_results_lie_on_the_host():
    fn = _fl_pair(np.random.default_rng(14), 16)[0]
    (r,) = BatchedEngine([fn]).run(3)
    assert r.order.device.type == "cpu" and r.gains.dtype == torch.float32
    assert r.order.dtype == torch.int32 and r.n_evals.dtype == torch.int32
    np.testing.assert_allclose(float(r.value), float(r.gains.sum()), rtol=1e-6)
    jres = jsolve(JSelectionSpec(JFacilityLocation.from_kernel(jnp.asarray(fn.sim.numpy())), 3))
    _near_ref(r, jres, 1e-5)
