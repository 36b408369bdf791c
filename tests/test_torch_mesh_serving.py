"""Serving on a mesh (``SelectionServer(mesh=)``, ``AsyncSelectionServer``,
sessions, ``solve(mode="served" | "async", mesh=)``) under rank 0's control
plane (``launch/mesh_plane.py``), on the CPU over ``gloo``.

Two worlds:
- a **world of 1** in this process (a file store) on a (1, 1) mesh: the
  fault matrix on the mesh (tests/test_resilience.py:197-270), the mesh
  breaker's single-device fallback (:336-353) and the refusals that charge
  it, LazyGreedy through the serving stack (tests/test_serving.py:405-420,
  502-510), the solve() routes;
- one **spawned 2x2 world** (``tests/_torch_dist_world.py``): rank 0 serves
  a mixed workload with batch pads and an FL request whose n the data axis
  does not divide, LazyGreedy, a round after an idle spell past the
  control group's timeout, async, a session and an FLMF request the mesh
  refuses; ranks 1-3 follow.  Then a follower dies and every other rank
  ends typed (``MeshFailed``) within the timeouts.

Every served answer equals the port's sequential solve bit for bit (ids,
gains, ``n_evals``, value) and the JAX package's sequential solve within
its ROADMAP bar (tests/test_serving.py:514-580).
"""
import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist_world import join_world, start_world
from _torch_serving_pairs import CPU, FAMILIES, near_ref, pair, same, stops
from repro.core import SelectionSpec as JSelectionSpec
from repro.core import solve as jsolve
from repro_torch.core import SelectionSpec, make_mesh, solve
from repro_torch.core.optimizers.batched import BatchedEngine
from repro_torch.interop import result_to_numpy
from repro_torch.launch import faults
from repro_torch.launch.async_serve import AsyncSelectionServer
from repro_torch.launch.coalesce import (
    SelectionRequest,
    bucket_for,
    bucket_size,
    group_key,
    group_label,
    pad_function,
    waves_for_group,
)
from repro_torch.launch.faults import FaultPlan, FaultSpec
from repro_torch.launch.mesh_plane import FollowerError, MeshFailed
from repro_torch.launch.resilience import BreakerBoard, BreakerOpen, RequestFailed, RetryPolicy
from repro_torch.launch.serve import FlushError, SelectionServer

POLICY = RetryPolicy(max_attempts=3, backoff_s=0.0, jitter=0.0)
LAZY = {"screen_k": 6}
CONTROL_S, IDLE_S = 4.0, 5.0  # the 2x2 world's control timeout and idle spell
DIES_TIMEOUT_S = 4.0


def _spec(kind, fn, budget, opt="NaiveGreedy"):
    return SelectionSpec(fn, budget, opt, **stops(kind), **(LAZY if opt == "LazyGreedy" else {}))


def _jref(kind, jfn, budget, opt="NaiveGreedy"):
    return jsolve(JSelectionSpec(jfn, budget, opt, **stops(kind),
                                 **(LAZY if opt == "LazyGreedy" else {})))


def _same_np(a, b, what=""):
    np.testing.assert_array_equal(a[0], b[0], err_msg=what)
    np.testing.assert_array_equal(a[1].view(np.int32), b[1].view(np.int32), err_msg=what)
    assert a[2] == b[2], (what, a[2], b[2])
    assert np.float32(a[3]).view(np.int32) == np.float32(b[3]).view(np.int32), what


def _near_np(a, jres, tol, what=""):
    np.testing.assert_array_equal(a[0], np.asarray(jres.order), err_msg=what)
    assert a[2] == int(jres.n_evals), (what, a[2], int(jres.n_evals))
    np.testing.assert_allclose(a[1], np.asarray(jres.gains), rtol=tol, atol=tol, err_msg=what)


# -- the coalescer on a mesh (no world) ----------------------------------------


def test_buckets_round_up_to_the_data_axis():
    """Power-of-two buckets rounded up to the data axis; the FL family's own
    n rounded up to it; an FLMF served at its own n keeps it (no shard
    rule: the mesh refuses its waves anyway); off a mesh nothing changes."""
    assert bucket_size(3, 4) == 4 and bucket_size(5, 4) == 8 and bucket_size(2, 3) == 3
    assert bucket_size(33) == 64 and bucket_size(33, 1) == 64
    rng = np.random.default_rng(40)
    for kind in ("fl", "flvmi", "flcg", "flcmi"):
        fn = pair(kind, rng, 23)[0]
        assert bucket_for(fn) == 23 and bucket_for(fn, 2) == 24 and bucket_for(fn, 3) == 24
        assert bucket_for(fn, 4) == 24 and bucket_for(fn, 5) == 25
    flmf = pair("flmf", rng, 23)[0]
    assert bucket_for(flmf, 2) == 23
    gc = pair("gc", rng, 23)[0]
    assert bucket_for(gc, 2) == 32 and bucket_for(gc, 3) == 33


@pytest.mark.parametrize("opt", ["NaiveGreedy", "LazyGreedy"])
@pytest.mark.parametrize("kind", ["fl", "fl_kernel", "flvmi", "flcg", "flcmi"])
def test_fl_family_rounded_to_the_data_axis_is_bit_exact(kind, opt):
    """An FL-family request of odd n padded with zero columns to the next
    multiple of 2 (and 4): its wave member equals the unpadded sequential
    solve bit for bit, since a column's sum runs over the rows in an order
    the column count does not change; the JAX package's within its bar.
    A size other than the rounded own n is refused."""
    rng = np.random.default_rng(41)
    fn, jfn = pair(kind, rng, 23)
    spec = _spec(kind, fn, 7, opt)
    want = solve(spec)
    for m in (2, 4):
        padded = pad_function(fn, bucket_for(fn, m), n_multiple=m)
        assert padded.n == 24 and type(padded) is type(fn)
        valid = np.zeros((2, 24), bool)
        valid[:, :23] = True
        got = BatchedEngine([padded, padded], valid=valid).run(
            [7, 0], spec.optimizer, stop_if_zero=spec.stop_if_zero,
            stop_if_negative=spec.stop_if_negative)[0]
        same(got, want, f"{kind} {opt} n_multiple {m}")
    near_ref(want, _jref(kind, jfn, 7, opt), FAMILIES[kind], kind)
    with pytest.raises(ValueError, match="own n"):
        pad_function(fn, 32, n_multiple=2)


def test_waves_pad_the_batch_to_the_batch_axis():
    """Batch pads are budget-0 copies of slot 0 whose valid rows follow slot
    0's true n; they are dropped at demux and counted as padded slots."""
    rng = np.random.default_rng(42)
    fns = [pair("fl", rng, 23)[0] for _ in range(3)]
    reqs = [SelectionRequest(rid=i, spec=SelectionSpec(f, 4 + i)) for i, f in enumerate(fns)]
    keys = {group_key(r, n_multiple=2) for r in reqs}
    assert len(keys) == 1 and group_label(reqs[0], n_multiple=2) == "FacilityLocation/n24/NaiveGreedy"
    assert group_label(reqs[0]) == "FacilityLocation/n23/NaiveGreedy"
    (wave,) = waves_for_group(reqs, n_multiple=2, b_multiple=4)
    assert wave.batch_size == 4 and wave.n_padded_slots == 1 and wave.n_bucket == 24
    assert wave.fns[3] is wave.fns[0] and wave.budgets == [4, 5, 6, 0]
    assert wave.valid.shape == (4, 24) and wave.valid[:, :23].all() and not wave.valid[:, 23].any()
    results = BatchedEngine(wave.fns, valid=wave.valid).run(
        wave.budgets, wave.optimizer, max_budget=wave.max_budget)
    out = wave.demux(results)
    assert sorted(out) == [0, 1, 2]
    for r in reqs:
        same(out[r.rid], solve(r.spec), f"member {r.rid}")
    (flat,) = waves_for_group(reqs)  # off a mesh: no pads, the own n
    assert flat.batch_size == 3 and flat.n_padded_slots == 0 and flat.n_bucket == 23


# -- a world of 1 in this process -------------------------------------------------


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A world of 1 over gloo with a (1, 1) ("batch", "data") mesh, torn down
    after the module (later test files run in the same worker)."""
    tmp = tmp_path_factory.mktemp("mesh1")
    timeout = datetime.timedelta(seconds=60)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=0,
                            world_size=1, timeout=timeout)
    try:
        yield make_mesh((1, 1), ("batch", "data"), device=CPU, timeout=timeout)
    finally:
        dist.destroy_process_group()


def _fl_spec(rng, n=32, budget=4, use_kernel=False):
    return SelectionSpec(pair("fl_kernel" if use_kernel else "fl", rng, n)[0], budget)


def _fb(rows, use_kernel=False):
    from repro_torch.core import FeatureBased

    return FeatureBased.from_features(rows, concave="sqrt", use_kernel=use_kernel, device=CPU)


def test_mesh_server_validates_its_mesh(mesh1):
    with pytest.raises(ValueError, match="no axis 'x'"):
        SelectionServer(mesh=mesh1, batch_axis="x")
    with pytest.raises(ValueError, match="no axis 'model'"):
        AsyncSelectionServer(mesh=mesh1, data_axis="model")
    with pytest.raises(TypeError, match="make_mesh"):
        SelectionServer(mesh=object())
    server = SelectionServer(mesh=mesh1)
    assert not server.is_follower and (server.b_multiple, server.n_multiple) == (1, 1)
    with pytest.raises(FollowerError, match="rank 0"):
        server.follow()
    server.close()
    with pytest.raises(MeshFailed, match="closed"):
        server.submit(_fl_spec(np.random.default_rng(43)))
    server.close()  # idempotent


def test_mesh_servers_release_their_control_groups(mesh1):
    """Each mesh server makes one control group and destroys it when it
    closes: servers built and closed again and again, and the solve()
    routes that build one a call, leave the process's groups as they
    found them."""
    from torch.distributed import distributed_c10d

    rng = np.random.default_rng(49)
    specs = [_fl_spec(rng), _fl_spec(rng)]
    before = len(distributed_c10d._world.pg_map)
    for _ in range(3):
        SelectionServer(mesh=mesh1).close()
        AsyncSelectionServer(mesh=mesh1).close()
    for mode in ("served", "async"):
        solve(specs, mode=mode, mesh=mesh1)
    assert len(distributed_c10d._world.pg_map) == before


def test_unit_mesh_mixed_workload_bit_identical(mesh1):
    """tests/test_serving.py:502-510: the CLI's mixed workload through the
    whole serving stack on a (1, 1) mesh, every answer bit-equal to its
    sequential solve and within its bar of the JAX package's."""
    rng = np.random.default_rng(44)
    kinds = ("fl", "gc", "fb", "sc", "psc", "dsum", "dmin", "flqmi", "gcmi", "logdet",
             "flvmi", "flcg", "flcmi")
    pairs = [(k, pair(k, rng, int(rng.choice([23, 32, 48])))) for k in kinds]
    specs = [_spec(k, f, 3 + i % 5, ("NaiveGreedy", "LazyGreedy")[i % 2])
             for i, (k, (f, _)) in enumerate(pairs)]
    server = SelectionServer(mesh=mesh1)
    for i, ((k, (_, jfn)), spec, resp) in enumerate(zip(pairs, specs, server.select(specs))):
        same(resp, solve(spec), k)
        near_ref(resp, _jref(k, jfn, spec.budget, spec.optimizer.name), FAMILIES[k], k)
        assert resp.degraded is None
    s = server.stats.summary()
    assert s["fallbacks_total"] == 0 and s["requests"] == len(specs)
    assert server.mesh_stats["waves"] == s["waves"]
    server.close()


def test_server_lazy_on_mesh_bit_identical(mesh1):
    """tests/test_serving.py:405-420: LazyGreedy through the serving stack on
    a mesh; n_evals equal too."""
    rng = np.random.default_rng(13)
    fns = [pair("fl", rng, 32)[0] for _ in range(3)] + [pair("gc", rng, 24)[0]]
    server = SelectionServer(mesh=mesh1)
    rids = [server.submit(SelectionSpec(fn, 5, "LazyGreedy")) for fn in fns]
    out = server.flush()
    for fn, rid in zip(fns, rids):
        same(out[rid], solve(SelectionSpec(fn, 5, "LazyGreedy")))
    server.close()


@pytest.mark.parametrize("route", ["sync", "async", "session"])
@pytest.mark.parametrize("site", ["dispatch", "padder", "kernel"])
def test_mesh_fault_matrix_every_rid_resolves_bit_identical(site, route, mesh1):
    """tests/test_resilience.py:197-270's mesh cells: a transient fault at
    each boundary, on the mesh; every rid resolves to exactly one answer,
    bit-equal to its sequential solve."""
    rng = np.random.default_rng(45)
    use_kernel = site == "kernel"
    specs = [_fl_spec(rng, 32, 4, use_kernel), _fl_spec(rng, 32, 3, use_kernel)]
    expected = [solve(s) for s in specs]
    server = SelectionServer(mesh=mesh1, retry_policy=POLICY)
    plan = FaultPlan([FaultSpec(site=site, times=1,
                                **({"mesh": True} if site == "dispatch" else {}))])
    if route == "sync":
        rids = [server.submit_spec(s) for s in specs]
        with faults.inject(plan):
            out = server.flush()
        assert not server.take_failures()
        assert sorted(out) == sorted(rids)
        for rid, want in zip(rids, expected):
            same(out[rid], want)
            assert out[rid].degraded is None
    elif route == "async":
        with AsyncSelectionServer(server, max_pending=100, flush_interval=600.0) as front:
            with faults.inject(plan):
                futures = [front.submit(s) for s in specs]
                for _ in range(4):  # padder faults need a re-drain round
                    front.flush_now()
                    if all(f.done() for f in futures):
                        break
                responses = [f.result(timeout=60) for f in futures]
        for want, resp in zip(expected, responses):
            same(resp, want)
    else:  # session
        f0 = rng.uniform(0, 1, size=(12, 6)).astype(np.float32)
        d1 = rng.uniform(0, 1, size=(6, 6)).astype(np.float32)
        session = server.open_session(SelectionSpec(_fb(f0, use_kernel), 5, retry=POLICY))
        with faults.inject(plan):
            upd = session.extend(features=d1)
        same(upd.result, solve(SelectionSpec(_fb(np.concatenate([f0, d1]), use_kernel), 5)))
    assert plan.counts()[0]["fired"] == 1
    assert server.metrics.counters["flush_errors"] >= 1
    assert server.metrics.counters["quarantined_total"] == 0
    assert server.metrics.counters["fallbacks_total"] == 0  # threshold 3: one fault
    server.close()


def test_mesh_fault_matrix_session_extend_boundary(mesh1):
    rng = np.random.default_rng(46)
    server = SelectionServer(mesh=mesh1, retry_policy=POLICY)
    f0 = rng.uniform(0, 1, size=(12, 6)).astype(np.float32)
    d1 = rng.uniform(0, 1, size=(6, 6)).astype(np.float32)
    session = server.open_session(SelectionSpec(_fb(f0), 5), sid="sx")
    with faults.inject(FaultPlan([FaultSpec(site="session-extend", session="sx")])):
        with pytest.raises(faults.InjectedFault):
            session.extend(features=d1)
        upd = session.extend(features=d1)
    assert upd.seq == 1
    same(upd.result, solve(SelectionSpec(_fb(np.concatenate([f0, d1])), 5)))
    server.close()


def test_mesh_breaker_trips_to_single_device_fallback(mesh1):
    """tests/test_resilience.py:336-353: persistent dispatch faults ON the
    mesh open the (family, mesh) breaker; the wave is served on one device,
    bit-identical, degraded="single-device" and counted.  Off-mesh dispatch
    faults are not charged to it."""
    rng = np.random.default_rng(47)
    spec = _fl_spec(rng)
    server = SelectionServer(mesh=mesh1, retry_policy=POLICY,
                             breakers=BreakerBoard(threshold=1))
    rid = server.submit_spec(spec)
    plan = FaultPlan([FaultSpec(site="dispatch", mesh=True, times=None)])
    with faults.inject(plan):
        out = server.flush()
    resp = out[rid]
    same(resp, solve(spec))
    assert resp.degraded == "single-device" and resp.attempts == 2
    assert server.breakers.states()["FacilityLocation/mesh"] == "open"
    assert server.metrics.counters["fallbacks_total"] == 1
    assert plan.counts()[0]["fired"] == 1  # the reroute is off the mesh
    waves = server.mesh_stats["waves"]
    assert waves == 0  # no plan went out for the degraded wave
    assert not server.take_failures()
    server.close()


@pytest.mark.parametrize("kind", ["flmf", "gc_kernel", "dsum_kernel", "dmin_kernel"])
def test_waves_the_mesh_refuses_charge_its_breaker(kind, mesh1):
    """A family without a shard rule (FLMF) or a use_kernel=True GraphCut /
    DisparitySum / DisparityMin is refused on the mesh before any plan goes
    out: the single-attempt flush fails typed and charges (family, "mesh");
    once it is open the family's waves run on one device, degraded, equal to
    the sequential solve."""
    rng = np.random.default_rng(48)
    fn = pair(kind, rng, 24)[0]
    spec = SelectionSpec(fn, 4, **stops(kind))
    fam = type(fn).__name__
    server = SelectionServer(mesh=mesh1, breakers=BreakerBoard(threshold=2, cooldown_s=600))
    for _ in range(2):
        rid = server.submit_spec(spec)
        with pytest.raises(FlushError) as ei:
            server.flush()
        assert isinstance(ei.value.__cause__, (NotImplementedError, ValueError))
        assert server.cancel(rid)
    assert server.breakers.states()[f"{fam}/mesh"] == "open"
    (resp,) = server.select([spec])
    same(resp, solve(spec), kind)
    assert resp.degraded == "single-device"
    assert server.stats.summary()["fallbacks_total"] == 1 and server.mesh_stats["waves"] == 0
    server.close()


def test_kernel_breaker_on_a_mesh_refuses_and_never_reroutes(mesh1):
    """A kernel fault on a mesh charges the kernel breaker, not the mesh
    one; the open kernel breaker refuses the family's kernel waves typed
    (BreakerOpen), with no fallback, on the mesh as off it."""
    rng = np.random.default_rng(49)
    spec = _fl_spec(rng, use_kernel=True)
    server = SelectionServer(mesh=mesh1, retry_policy=POLICY, breakers=BreakerBoard(threshold=1))
    rid = server.submit_spec(spec)
    with faults.inject(FaultPlan([FaultSpec(site="kernel", times=None)])):
        out = server.flush()
    assert rid not in out
    err = server.take_failures()[rid]
    assert isinstance(err, RequestFailed) and err.reason == "breaker_open"
    assert isinstance(err.__cause__, BreakerOpen)
    assert server.breakers.states() == {"FacilityLocation/kernel": "open",
                                        "FacilityLocation/mesh": "closed"}
    assert server.metrics.counters["fallbacks_total"] == 0
    server.close()


def test_solve_served_and_async_on_a_mesh(mesh1):
    """solve(mode="served" | "async", mesh=) serve instead of raising, each
    spec bit-equal to its sequential solve; a mesh server of the caller's
    serves too."""
    rng = np.random.default_rng(50)
    specs = [_spec("fl", pair("fl", rng, 23)[0], 5, "LazyGreedy"),
             _spec("fb", pair("fb", rng, 20)[0], 4),
             _spec("dsum", pair("dsum", rng, 17)[0], 6)]
    seq = [solve(s) for s in specs]
    for mode in ("served", "async"):
        for got, want in zip(solve(specs, mode=mode, mesh=mesh1), seq):
            same(got, want, mode)
    server = SelectionServer(mesh=mesh1)
    for got, want in zip(solve(specs, mode="served", server=server), seq):
        same(got, want, "own server")
    server.close()
    with AsyncSelectionServer(mesh=mesh1, flush_interval=0.01) as front:
        for got, want in zip([f.result(timeout=60) for f in map(front.submit, specs)], seq):
            same(got, want, "async timer")
    with pytest.raises(MeshFailed, match="closed"):
        front._server.submit(specs[0])  # the front end built it, and closed it


# -- the spawned 2x2 world ---------------------------------------------------------


def _req(kind, fn, budget, opt="NaiveGreedy"):
    return {"fn": fn, "budget": budget, "optimizer": opt,
            "params": LAZY if opt == "LazyGreedy" else {},
            "stops": tuple(stops(kind).values())}


def _workload():
    """name -> [(kind, JAX fn, request)]: the rounds the 2x2 world serves."""
    rng = np.random.default_rng(60)

    def reqs(plan, opt="NaiveGreedy"):
        out = []
        for k, (kind, n, budget) in enumerate(plan):
            fn, jfn = pair(kind, rng, n)
            out.append((kind, jfn, _req(kind, fn, budget,
                                        opt if opt != "mixed" else ("NaiveGreedy", "LazyGreedy")[k % 2])))
        return out

    return {
        # three odd-n FL requests: n 23 -> 24 on the data axis, one wave of 3
        # padded to 4 on the batch axis; singletons padded to 2; an FLMF the
        # mesh refuses (served degraded once its breaker opens)
        "mixed": reqs([("fl", 23, 6), ("fl", 23, 3), ("fl", 23, 5), ("gc", 20, 4), ("gc", 30, 6),
                       ("fb", 30, 5), ("sc", 17, 4), ("psc", 24, 5), ("dsum", 20, 6),
                       ("dmin", 20, 5), ("gcmi", 19, 3), ("logdet", 16, 4), ("flqmi", 21, 5),
                       ("flvmi", 25, 4), ("flcg", 25, 5), ("flcmi", 25, 3), ("flmf", 24, 4)]),
        "lazy": reqs([("fl", 32, 6), ("fl", 27, 4), ("gc", 24, 5), ("fb", 20, 6), ("sc", 28, 5),
                      ("flcg", 31, 4)], "LazyGreedy"),
        "after_idle": reqs([("fl", 23, 4), ("psc", 20, 3)]),
        "async": reqs([("fl", 32, 5), ("fl", 32, 4), ("fb", 24, 3), ("gc", 24, 4), ("sc", 17, 3)],
                      "mixed"),
        "solve": reqs([("fl", 23, 4), ("fb", 20, 3), ("dsum", 17, 5)], "mixed"),
    }


def _session():
    rng = np.random.default_rng(61)
    f0 = rng.uniform(0, 1, size=(12, 6)).astype(np.float32)
    deltas = [rng.uniform(0, 1, size=(m, 6)).astype(np.float32) for m in (7, 1, 13)]
    return f0, deltas, 5


@pytest.fixture(scope="module")
def workload():
    return _workload()


@pytest.fixture(scope="module")
def world4(workload, tmp_path_factory):
    """Every rank's results of the 2x2 serving world, its ranks' exit codes
    and the wall of the world's dying part."""
    tmp = tmp_path_factory.mktemp("mesh_world4")
    job = {
        "meshes": {"bd": ((2, 2), ("batch", "data"))},
        "serving": {
            "mesh": "bd", "control_timeout_s": CONTROL_S, "idle_s": IDLE_S, "max_pending": 3,
            "rounds": {name: [r for _, _, r in reqs] for name, reqs in workload.items()},
            "session": _session(),
        },
        "serve_dies": {"rank": 3, "timeout_s": DIES_TIMEOUT_S,
                       "request": workload["after_idle"][0][2]},
    }
    t0 = time.monotonic()
    codes = join_world(start_world(job, 4, tmp), tmp, timeout=120)
    wall = time.monotonic() - t0
    bad = [f"rank {r}: exit {rc}\n{err}" for r, (rc, err) in enumerate(codes) if rc and r != 3]
    assert not bad, "\n".join(bad)
    ranks = [torch.load(tmp / f"result{r}.pt", weights_only=False)["serving"] for r in range(4)]
    dies = [torch.load(tmp / f"dies{r}.pt", weights_only=False) for r in range(3)]
    return ranks, dies, [rc for rc, _ in codes], wall


ROUNDS = ("mixed", "lazy", "after_idle", "async")


@pytest.mark.parametrize("name", ROUNDS)
def test_world4_rounds_bit_equal_to_sequential_and_jax(name, workload, world4):
    """Rank 0's answers: bit-equal to its sequential solves, within the bar
    of the JAX package's."""
    ranks, _, _, _ = world4
    got, seq = ranks[0]["rounds"][name], ranks[0]["sequential"][name]
    assert len(got) == len(workload[name])
    for k, (resp, want, (kind, jfn, req)) in enumerate(zip(got, seq, workload[name])):
        what = f"{name} {k} {kind}"
        _same_np(resp["result"], want, what)
        _near_np(resp["result"], _jref(kind, jfn, req["budget"], req["optimizer"]),
                 FAMILIES[kind], what)
        assert resp["degraded"] == ("single-device" if kind == "flmf" else None), what


def test_world4_pads_the_odd_fl_request_and_the_batch(world4):
    """The FL requests of n = 23 rode at 24 on the data axis of 2, three to
    a wave padded to 4 on the batch axis; every group's batch was padded."""
    ranks, _, _, _ = world4
    fl = ranks[0]["rounds"]["mixed"][:3]
    assert {r["n_bucket"] for r in fl} == {24} and {r["wave_size"] for r in fl} == {3}
    assert ranks[0]["rounds"]["mixed"][3]["n_bucket"] == 32  # GraphCut's bucket
    stats = ranks[0]["stats"]
    assert stats["padded_slots"] >= 1 + 14 and stats["slots"] % 2 == 0
    assert stats["fallbacks_total"] == 1  # the FLMF wave, and only it
    assert stats["breaker_state"] == {"FacilityLocationMF/mesh": "open"}


def test_world4_session_and_solve_routes(world4):
    """The session's updates equal solve() over the stream so far; the
    solve() routes return rank 0's results on every rank."""
    from repro_torch.core import FeatureBased

    ranks, _, _, _ = world4
    f0, deltas, budget = _session()
    stream = f0
    for upd, x in zip(ranks[0]["rounds"]["session"], deltas):
        stream = np.concatenate([stream, x])
        want = solve(SelectionSpec(FeatureBased.from_features(stream, concave="sqrt",
                                                              device=CPU), budget))
        _same_np(upd, result_to_numpy(want), f"session at {len(stream)}")
    for mode in ("served", "async"):
        for r in ranks:
            for got, want in zip(r["solve"][mode], ranks[0]["sequential"]["solve"]):
                _same_np(got, want, f"solve {mode}")


def test_world4_followers_follow_rank_0(world4):
    """A follower's submit and flush raise typed, naming rank 0; each ran as
    many mesh waves as rank 0 sent, with the same results (the digests);
    rank 0's close() ended their follow()."""
    ranks, _, _, _ = world4
    lead = ranks[0]["mesh"]
    assert lead["waves"] >= 10 and lead["plan_bytes"] > 0 and lead["broadcast_s"] > 0
    for r in ranks[1:]:
        assert r["follower_submit"][0] == "FollowerError" and "rank 0" in r["follower_submit"][1]
        assert r["follower_flush"][0] == "FollowerError"
        assert r["follower_async_submit"][0] == "FollowerError"
        assert r["followed"] is None
        assert r["mesh"]["waves"] == lead["waves"] and r["digest"] == ranks[0]["digest"]


def test_world4_idle_server_outlives_the_control_timeout(world4):
    """Rank 0 idled longer than the control group's timeout between two
    rounds: its idle headers kept the followers, and the next round was
    served."""
    assert IDLE_S > CONTROL_S
    ranks, _, _, _ = world4
    assert len(ranks[0]["rounds"]["after_idle"]) == 2


def test_world4_a_dead_follower_ends_every_rank_typed(world4):
    """Follower 3 exits while idle: rank 0's next wave and every later call
    fail with MeshFailed, and followers 1 and 2 end with MeshFailed, each
    within the timeouts (never the test run's clock)."""
    _, dies, codes, wall = world4
    assert codes == [0, 0, 0, 3]
    for r, d in enumerate(dies):
        assert d["outcome"] == "MeshFailed", (r, d)
        assert d["seconds"] < 4 * DIES_TIMEOUT_S, (r, d)
    assert dies[0]["later"][0] == "MeshFailed"
    assert wall < 110
