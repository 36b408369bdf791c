"""The port's long-lived selection sessions (``repro_torch.launch.sessions``)
on the CPU: a session fed deltas equals one direct ``solve()`` over the
stream bit for bit (ids, gains, ``n_evals``, value), whatever the sizes of
its deltas, and the JAX package's direct solve over the same rows (ids and
``n_evals`` equal, gains within the family's bar).

Mirrors the single-device session tests of tests/test_streaming.py, with
SieveStreaming / ThresholdGreedy as there (seeded arrival orders and
constraints included) and NaiveGreedy / LazyGreedy besides.
"""
import numpy as np
import pytest
import torch

from repro.core import FacilityLocationMF as JFacilityLocationMF
from repro.core import FeatureBased as JFeatureBased
from repro.core import Knapsack as JKnapsack
from repro.core import SelectionSpec as JSelectionSpec
from repro.core import solve as jsolve
from repro_torch.core import (
    DisparitySum,
    FacilityLocation,
    FacilityLocationMF,
    FeatureBased,
    GraphCut,
    Knapsack,
    PartitionMatroid,
    ProbabilisticSetCover,
    SelectionSpec,
    SetCover,
    create_kernel,
    sc_mi,
    solve,
)
from repro_torch.interop import result_to_numpy
from repro_torch.launch.serve import SelectionServer
from repro_torch.launch.sessions import (
    SessionClosed,
    resolve_extender,
    resolve_restrictor,
)

from _torch_serving_pairs import CPU, near_ref, pair, same

# uneven delta sizes: 1 row, a prime, a power of two, and the rest
UNEVEN = (1, 7, 16, 3)


def _chunks(rows, sizes):
    out, lo = [], 0
    for s in sizes:
        out.append(rows[lo : lo + s])
        lo += s
    return out + ([rows[lo:]] if lo < len(rows) else [])


def _grow(spec, deltas, server=None):
    session = (server or SelectionServer()).open_session(spec)
    for d in deltas:
        upd = session.extend(features=d)
    session.close()
    return upd


STREAMING = ("SieveStreaming", "ThresholdGreedy")


@pytest.mark.parametrize("optimizer", ["NaiveGreedy", "LazyGreedy", *STREAMING])
def test_session_ten_deltas_bit_identical_to_direct_solve(optimizer):
    """10 feature deltas through a session == one solve() over the
    concatenated stream (the port's bits; the JAX package's ids)."""
    rng = np.random.default_rng(0)
    rows = rng.uniform(0, 1, size=(44, 6)).astype(np.float32)
    opts = {"epsilon": 0.1} if optimizer in STREAMING else {}
    spec = SelectionSpec(FeatureBased.from_features(rows[:4], device=CPU), 5, optimizer, **opts)
    session = SelectionServer().open_session(spec)
    for lo in range(4, 44, 4):
        upd = session.extend(features=rows[lo : lo + 4])
    assert session.deltas_absorbed == 10 and upd.seq == 10 and upd.n_total == 44
    direct = solve(SelectionSpec(FeatureBased.from_features(rows, device=CPU), 5, optimizer,
                                 **opts))
    same(upd.result, direct)
    assert [j for j, _ in upd.selection] == [int(j) for j in direct.order.tolist() if j >= 0]
    near_ref(upd.result, jsolve(JSelectionSpec(JFeatureBased.from_features(rows), 5,
                                               optimizer, **opts)), 1e-4)
    session.close()


@pytest.mark.parametrize("metric", ["dot", "cosine", "euclidean", "rbf"])
def test_session_single_extend_equals_many_deltas(metric):
    """FacilityLocationMF over a FeatureSource: deltas of 1, 7, 16, 3 rows
    and the rest, one extend of the whole stream and a direct build of it
    give the same source, so the same answer bit for bit (the cosine rows'
    norms sum in an order set by d alone)."""
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(40, 7)).astype(np.float32)

    def spec(x):
        return SelectionSpec(FacilityLocationMF.from_features(x, metric=metric, device=CPU), 5,
                             "LazyGreedy")

    many = _grow(spec(rows[:6]), _chunks(rows[6:], UNEVEN))
    one = _grow(spec(rows[:6]), [rows[6:]])
    direct = solve(spec(rows))
    same(many.result, one.result, metric)
    same(direct, one.result, metric)
    grown = resolve_extender(FacilityLocationMF)(spec(rows[:6]).fn, rows[6:])
    built = spec(rows).fn
    for name in ("x", "y", "xx", "yy"):
        assert torch.equal(getattr(grown.src, name), getattr(built.src, name)), (metric, name)
    tol = 2e-3 if metric == "euclidean" else 2e-5
    near_ref(direct, jsolve(JSelectionSpec(JFacilityLocationMF.from_features(rows, metric=metric),
                                           5, "LazyGreedy")), tol, metric)


@pytest.mark.parametrize("family", ["fb", "sc", "psc", "flmf_rows"])
def test_every_extender_is_concatenation_associative(family):
    """Each built-in extender, fed uneven deltas, builds the tensors a
    direct build of the whole stream holds, bit for bit, and the session's
    last answer equals the direct solve."""
    rng = np.random.default_rng(2)
    if family == "fb":
        raw = rng.uniform(-0.2, 1, size=(30, 5)).astype(np.float32)
        build = lambda x: FeatureBased.from_features(x, concave="log", device=CPU)  # noqa: E731
        names = ("feats",)
    elif family == "sc":
        raw = rng.integers(0, 2, size=(30, 9)).astype(np.float32)
        build = lambda x: SetCover.from_cover(x, device=CPU)  # noqa: E731
        names = ("cover",)
    elif family == "psc":
        raw = rng.uniform(0, 1, size=(30, 9)).astype(np.float32)
        build = lambda x: ProbabilisticSetCover.from_probs(x, device=CPU)  # noqa: E731
        names = ("log_miss", "probs")
    else:  # a FeatureSource with fixed represented rows, growing columns
        reps = rng.normal(size=(6, 4)).astype(np.float32)
        raw = rng.normal(size=(30, 4)).astype(np.float32)
        build = lambda x: FacilityLocationMF.from_features(  # noqa: E731
            reps, x, metric="cosine", device=CPU)
        names = ()
    grown = build(raw[:4])
    for d in _chunks(raw[4:], UNEVEN):
        grown = resolve_extender(type(grown))(grown, d)
    built = build(raw)
    for name in names:
        assert torch.equal(getattr(grown, name), getattr(built, name)), (family, name)
    if family == "flmf_rows":
        assert torch.equal(grown.src.y, built.src.y) and torch.equal(grown.src.yy, built.src.yy)
    upd = _grow(SelectionSpec(build(raw[:4]), 6), _chunks(raw[4:], UNEVEN))
    same(upd.result, solve(SelectionSpec(built, 6)), family)


def test_session_arrival_order_is_replayed_deterministically():
    rng = np.random.default_rng(3)
    rows = rng.uniform(0, 1, size=(30, 5)).astype(np.float32)

    def run():
        sess = SelectionServer().open_session(
            SelectionSpec(FeatureBased.from_features(rows[:10], device=CPU), 4, "LazyGreedy"))
        ups = [sess.extend(features=rows[lo : lo + 10]) for lo in (10, 20)]
        sess.close()
        return ups

    for ua, ub in zip(run(), run()):
        same(ua.result, ub.result)
        assert ua.selection == ub.selection


@pytest.mark.parametrize("optimizer", STREAMING)
def test_streaming_session_single_extend_equals_many_deltas(optimizer):
    """tests/test_streaming.py's streaming form: a FacilityLocationMF over
    features fed uneven deltas, one extend and a direct build stream the
    same answer bit for bit, the JAX package's ids."""
    rows = np.random.default_rng(4).normal(size=(36, 7)).astype(np.float32)

    def spec(x):
        return SelectionSpec(FacilityLocationMF.from_features(x, device=CPU), 4, optimizer,
                             epsilon=0.1)

    many = _grow(spec(rows[:6]), _chunks(rows[6:], UNEVEN))
    one = _grow(spec(rows[:6]), [rows[6:]])
    same(many.result, one.result)
    same(solve(spec(rows)), one.result)
    near_ref(one.result, jsolve(JSelectionSpec(JFacilityLocationMF.from_features(rows), 4,
                                               optimizer, epsilon=0.1)), 2e-5)


@pytest.mark.parametrize("optimizer", STREAMING)
def test_streaming_session_seeded_arrivals_replay_deterministically(optimizer):
    """Same seed and deltas: bit-identical updates at every step, the
    seeded arrival order included, each equal to the direct solve."""
    rows = np.random.default_rng(5).uniform(0, 1, size=(30, 5)).astype(np.float32)

    def run():
        sess = SelectionServer().open_session(
            SelectionSpec(FeatureBased.from_features(rows[:10], device=CPU), 4, optimizer,
                          epsilon=0.2, seed=7))
        ups = [sess.extend(features=rows[lo : lo + 10]) for lo in (10, 20)]
        sess.close()
        return ups

    a, b = run(), run()
    for ua, ub in zip(a, b):
        same(ua.result, ub.result)
        assert ua.selection == ub.selection
    same(a[-1].result, solve(SelectionSpec(FeatureBased.from_features(rows, device=CPU), 4,
                                           optimizer, epsilon=0.2, seed=7)))


def test_streaming_session_under_constraint():
    """Sessions and constraints compose: every update respects the
    knapsack, the last equals the direct constrained solve bit for bit and
    the JAX package's ids."""
    rng = np.random.default_rng(6)
    rows = rng.uniform(0, 1, size=(24, 5)).astype(np.float32)
    costs = tuple(float(c) for c in rng.uniform(0.4, 1.2, size=24))
    sess = SelectionServer().open_session(
        SelectionSpec(FeatureBased.from_features(rows[:8], device=CPU), 5, "SieveStreaming",
                      epsilon=0.1, constraint=Knapsack(costs, 2.0)))
    for lo in (8, 16):
        upd = sess.extend(features=rows[lo : lo + 8])
        assert sum(costs[j] for j, _ in upd.selection) <= 2.0 + 1e-6
    sess.close()
    direct = solve(SelectionSpec(FeatureBased.from_features(rows, device=CPU), 5,
                                 "SieveStreaming", epsilon=0.1, constraint=Knapsack(costs, 2.0)))
    same(direct, upd.result)
    near_ref(direct, jsolve(JSelectionSpec(JFeatureBased.from_features(rows), 5, "SieveStreaming",
                                           epsilon=0.1, constraint=JKnapsack(costs, 2.0))), 1e-4)


def test_constrained_streaming_served_equals_sequential():
    """The constraint rides the OptimizerSpec as static metadata, so a
    constrained streaming request coalesces and serves bit-identically."""
    x = np.random.default_rng(7).normal(size=(24, 8)).astype(np.float32)
    fn = FacilityLocation.from_kernel(create_kernel(x, metric="euclidean", device=CPU))
    cons = PartitionMatroid(tuple(int(v) for v in np.arange(24) % 3), (2, 2, 2))
    spec = SelectionSpec(fn, 5, "SieveStreaming", epsilon=0.1, constraint=cons)
    same(SelectionServer().select([spec])[0].result, solve(spec))


def test_session_indices_mode_maps_universe_ids():
    """Indices mode: the restricted function keeps the universe function's
    values, updates report universe ids, and the answer equals a direct
    solve on the active set (ids mapped back)."""
    uni = pair("fl", np.random.default_rng(4), 30)[0]
    sess = SelectionServer().open_session(SelectionSpec(uni, 4))
    sess.extend(indices=[3, 7, 11])
    upd = sess.extend(indices=[0, 7, 20, 25, 14])  # 7 repeats: ignored
    assert upd.n_total == 7 and upd.n_delta == 4
    active = [3, 7, 11, 0, 20, 25, 14]
    ids = [j for j, _ in upd.selection]
    assert set(ids) <= set(active)
    direct = solve(SelectionSpec(FacilityLocation.from_kernel(uni.sim[:, active]), 4))
    assert ids == [active[j] for j in direct.order.tolist() if j >= 0]
    same(upd.result, direct)
    mask = np.zeros(30, bool)
    mask[ids] = True
    np.testing.assert_allclose(float(uni.evaluate(torch.as_tensor(mask))),
                               float(result_to_numpy(upd.result)[3]), rtol=1e-5)
    sess.close()


@pytest.mark.parametrize("kind", ["gc", "fb", "sc", "psc", "flmf_dense", "flmf"])
def test_session_restrictors_are_value_preserving(kind):
    """The restricted function agrees with the universe function on every
    subset of the active set."""
    rng = np.random.default_rng(5)
    uni = pair(kind, rng, 24)[0]
    active = torch.tensor([1, 4, 9, 13, 17, 21])
    sub = resolve_restrictor(type(uni))(uni, active)
    assert sub.n == 6
    local = torch.tensor([True, False, True, True, False, False])
    mask = torch.zeros(24, dtype=torch.bool)
    mask[active[local]] = True
    np.testing.assert_allclose(float(sub.evaluate(local)), float(uni.evaluate(mask)), rtol=1e-5)


def test_session_mode_and_lifecycle_discipline():
    rng = np.random.default_rng(6)
    rows = rng.uniform(0, 1, size=(12, 4)).astype(np.float32)
    server = SelectionServer()
    sess = server.open_session(SelectionSpec(FeatureBased.from_features(rows[:6], device=CPU), 3))
    assert sess.mode is None
    sess.extend(features=rows[6:9])
    assert sess.mode == "features"
    with pytest.raises(ValueError, match="features.*mode"):
        sess.extend(indices=[0])
    with pytest.raises(TypeError, match="exactly one"):
        sess.extend()
    with pytest.raises(TypeError, match="exactly one"):
        sess.extend(features=rows[9:], indices=[0])
    sess.close()
    sess.close()
    assert sess.closed
    with pytest.raises(SessionClosed):
        sess.extend(features=rows[9:])
    s2 = server.open_session(SelectionSpec(pair("fl", rng, 10)[0], 3))
    with pytest.raises(ValueError, match="universe"):
        s2.extend(indices=[99])
    with pytest.raises(TypeError, match="SelectionSpec"):
        server.open_session("not a spec")
    d = np.ones((6, 6), np.float32) - np.eye(6, dtype=np.float32)
    s3 = server.open_session(SelectionSpec(DisparitySum.from_distance(d, device=CPU), 2))
    with pytest.raises(NotImplementedError, match="register_feature_extender"):
        s3.extend(features=np.ones((1, 6), np.float32))
    with pytest.raises(NotImplementedError, match="register_restrictor"):
        s3.extend(indices=[0])


def test_session_metrics_roll_up():
    rng = np.random.default_rng(7)
    rows = rng.uniform(0, 1, size=(24, 5)).astype(np.float32)
    server = SelectionServer()
    sess = server.open_session(SelectionSpec(FeatureBased.from_features(rows[:8], device=CPU), 3))
    u1 = sess.extend(features=rows[8:16])
    u2 = sess.extend(features=rows[16:])
    sess.close()
    c = server.metrics.counters
    assert c["sessions_opened"] == 1 and c["sessions_closed"] == 1
    assert c["session_deltas"] == 2
    assert u1.churn == len(u1.selection)
    assert c["session_churn"] == u1.churn + u2.churn == sess.churn_total
    assert server.metrics.snapshot()["delta_s"]["count"] == 2
    assert sess.last_update is u2 and u2.latency_s > 0


def test_session_hooks_resolve_along_mro():
    eye = np.eye(6, dtype=np.float32)
    fn = sc_mi(eye, np.ones(6, np.float32), eye[:2], device=CPU)
    assert resolve_extender(type(fn)) is resolve_extender(SetCover)

    class CustomSC(SetCover):
        pass

    assert resolve_extender(CustomSC) is resolve_extender(SetCover)
    assert resolve_restrictor(CustomSC) is resolve_restrictor(SetCover)
    assert resolve_restrictor(GraphCut) is not resolve_restrictor(SetCover)


def test_session_takes_tensor_deltas_and_journals_them(tmp_path):
    """Deltas may be tensors where the function lives (on the card they are
    never copied to the host for the extend); the journal holds them as
    numpy and a restore replays the same stream."""
    from repro_torch.launch.sessions import SessionJournal, restore_sessions

    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(size=(30, 6)).astype(np.float32))
    spec = SelectionSpec(FacilityLocationMF.from_features(x[:5], metric="cosine", device=CPU), 4)
    journal = SessionJournal(tmp_path / "j")
    sess = SelectionServer().open_session(spec, sid="t", journal=journal)
    for d in _chunks(x[5:], UNEVEN):
        upd = sess.extend(features=d)
    same(upd.result, solve(SelectionSpec(FacilityLocationMF.from_features(x, metric="cosine",
                                                                          device=CPU), 4)))
    sizes = [int(d.shape[0]) for d in _chunks(x[5:], UNEVEN)]
    assert [d["payload"].shape[0] for d in journal.deltas("t")] == sizes == [1, 7, 16, 1]
    restored = restore_sessions(SelectionServer(), journal, {"t": spec})["t"]
    same(restored.last_update.result, upd.result)
    universe = SelectionServer().open_session(SelectionSpec(pair("fl", rng, 12)[0], 3))
    assert universe.extend(indices=torch.tensor([4, 1, 9])).n_total == 3
