"""The port's fault injection, retries, breakers and crash-safe sessions
(``repro_torch.launch.faults`` / ``resilience`` / ``sessions``) on the CPU.

Mirrors tests/test_resilience.py without its mesh cells (ROADMAP queue 1,
item 11):

- every submitted rid resolves to EXACTLY ONE response or one typed
  ``RequestFailed`` under every fault class, and recovered answers equal
  the port's sequential ``solve()`` bit for bit;
- only kernel faults charge a family's kernel breaker, and an open one
  refuses that family's kernel waves typed (``BreakerOpen``,
  ``RequestFailed(reason="breaker_open")``): no answer is served off the
  kernels its sequential solve takes;
- the retry delays equal the JAX package's value for value;
- timeouts are driven by replacing ``coalesce.clock``, not by racing the
  wall clock.
"""
import numpy as np
import pytest
import torch

from repro.core import FeatureBased as JFeatureBased
from repro.core import SelectionSpec as JSelectionSpec
from repro.core import solve as jsolve
from repro.launch import resilience as jresilience
from repro_torch.core import FeatureBased, SelectionSpec, solve
from repro_torch.launch import coalesce, faults
from repro_torch.launch.async_serve import AsyncSelectionServer
from repro_torch.launch.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.kernels._build import KernelError
from repro_torch.launch.resilience import (
    SINGLE_ATTEMPT,
    BreakerBoard,
    BreakerOpen,
    CircuitBreaker,
    RequestFailed,
    RetryPolicy,
)
from repro_torch.launch.serve import FlushError, SelectionServer
from repro_torch.launch.sessions import SessionJournal, restore_sessions

from _torch_serving_pairs import CPU, near_ref, pair, same

# no-backoff policy: fault-matrix cells retry instantly, tests stay fast
POLICY = RetryPolicy(max_attempts=3, backoff_s=0.0, jitter=0.0)


def _fl_spec(rng, n=32, budget=4, use_kernel=False):
    return SelectionSpec(pair("fl_kernel" if use_kernel else "fl", rng, n)[0], budget)


def _fb(rows, use_kernel=False):
    return FeatureBased.from_features(rows, concave="sqrt", use_kernel=use_kernel, device=CPU)


# -- faults.py units ----------------------------------------------------------


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="site"):
        FaultSpec(site="nope")
    with pytest.raises(ValueError, match="times"):
        FaultSpec(site="dispatch", times=0)
    with pytest.raises(ValueError, match="rate"):
        FaultSpec(site="dispatch", rate=1.5)
    with pytest.raises(ValueError, match="after"):
        FaultSpec(site="dispatch", after=-1)
    with pytest.raises(ValueError, match="delay_s"):
        FaultSpec(site="dispatch", delay_s=-0.1)


def test_fault_spec_addressing():
    fs = FaultSpec(site="dispatch", family="FacilityLocation", backend="cuda-*")
    assert fs.matches("dispatch", {"family": "FacilityLocation", "backend": "cuda-fl"})
    assert not fs.matches("dispatch", {"family": "GraphCut", "backend": "cuda-fl"})
    assert not fs.matches("dispatch", {"family": "FacilityLocation", "backend": "torch"})
    assert not fs.matches("kernel", {"family": "FacilityLocation", "backend": "cuda-fl"})
    rid = FaultSpec(site="dispatch", rid=7)
    assert rid.matches("dispatch", {"rids": (3, 7)})
    assert not rid.matches("dispatch", {"rids": (3, 4)})
    mesh = FaultSpec(site="dispatch", mesh=False)
    assert mesh.matches("dispatch", {"mesh": False}) and not mesh.matches("dispatch", {"mesh": True})


def test_fault_plan_times_after_budgets():
    plan = FaultPlan([FaultSpec(site="dispatch", times=2, after=1)])
    fired = [plan.fires("dispatch", {}) is not None for _ in range(5)]
    assert fired == [False, True, True, False, False]
    assert plan.counts() == [{"site": "dispatch", "matched": 5, "fired": 2}]


def test_fault_plan_rate_is_seeded_deterministic():
    """Same seed, same draws — and the JAX package's plan draws the same."""
    from repro.launch.faults import FaultPlan as JFaultPlan
    from repro.launch.faults import FaultSpec as JFaultSpec

    draws = []
    for plan in (FaultPlan([FaultSpec(site="dispatch", times=None, rate=0.5)], seed=7),
                 FaultPlan([FaultSpec(site="dispatch", times=None, rate=0.5)], seed=7),
                 JFaultPlan([JFaultSpec(site="dispatch", times=None, rate=0.5)], seed=7)):
        draws.append([plan.fires("dispatch", {}) is not None for _ in range(32)])
    assert draws[0] == draws[1] == draws[2]
    assert any(draws[0]) and not all(draws[0])


def test_inject_raises_only_while_armed_and_suspends():
    faults.check("dispatch")
    plan = FaultPlan([FaultSpec(site="dispatch", times=None)])
    with faults.inject(plan):
        assert faults.active_plan() is plan
        with faults.suspended():
            faults.check("dispatch")
        with pytest.raises(InjectedFault) as ei:
            faults.check("dispatch", family="X")
        assert ei.value.site == "dispatch" and ei.value.attrs["family"] == "X"
    faults.check("dispatch")
    assert faults.active_plan() is None
    assert plan.counts()[0]["fired"] == 1


def test_kernel_boundary_fires_in_resolve_backend():
    """resolve_backend crosses the "kernel" boundary for a CUDA-kernel
    backend (named cuda-*) and never for the torch sweeps."""
    from repro_torch.core import resolve_backend

    rng = np.random.default_rng(1)
    on, off = _fl_spec(rng, use_kernel=True).fn, _fl_spec(rng).fn
    plan = FaultPlan([FaultSpec(site="kernel", backend="cuda-*", times=None)])
    with faults.inject(plan):
        assert resolve_backend(off).name == "torch"
        with pytest.raises(InjectedFault) as ei:
            resolve_backend(on)
    assert ei.value.attrs == {"family": "FacilityLocation", "backend": "cuda-fl"}
    assert plan.counts()[0] == {"site": "kernel", "matched": 1, "fired": 1}


# -- resilience.py units ------------------------------------------------------


def test_retry_policy_validation():
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="backoff_mult"):
        RetryPolicy(backoff_mult=0.5)
    with pytest.raises(ValueError, match="jitter"):
        RetryPolicy(jitter=2.0)
    with pytest.raises(ValueError, match="timeout_s"):
        RetryPolicy(timeout_s=0.0)
    assert SINGLE_ATTEMPT.max_attempts == 1


def test_backoff_equals_the_reference_value_for_value():
    """The schedule, its cap and the jitter (a pure function of the request
    id and the attempt) equal the JAX package's delays exactly."""
    p = RetryPolicy(backoff_s=0.01, backoff_mult=2.0, max_backoff_s=0.05, jitter=0.0)
    assert p.backoff(1) == pytest.approx(0.01) and p.backoff(10) == pytest.approx(0.05)
    for kw in ({"backoff_s": 0.01, "jitter": 0.5}, {"backoff_s": 0.2, "backoff_mult": 3.0,
                                                    "max_backoff_s": 2.0, "jitter": 0.25}):
        mine, ref = RetryPolicy(**kw), jresilience.RetryPolicy(**kw)
        for attempt in range(1, 7):
            for seed in (0, 7, "rid-9", ("s", 3)):
                assert mine.backoff(attempt, seed=seed) == ref.backoff(attempt, seed=seed)
    j = RetryPolicy(backoff_s=0.01, jitter=0.5)
    assert j.backoff(2, seed="rid-9") != j.backoff(2, seed="rid-10")


def test_retry_policy_rides_spec_round_trip():
    pol = RetryPolicy(max_attempts=5, timeout_s=2.0)
    spec = SelectionSpec(_fl_spec(np.random.default_rng(2)).fn, 4, retry=pol, deadline_s=0.5)
    assert spec.retry == pol and spec.deadline_s == 0.5
    assert RetryPolicy.from_dict(pol.to_dict()) == pol
    assert pol.to_dict() == jresilience.RetryPolicy(max_attempts=5, timeout_s=2.0).to_dict()
    with pytest.raises(ValueError, match="deadline_s"):
        SelectionSpec(spec.fn, 4, deadline_s=float("inf"))
    with pytest.raises(TypeError, match="RetryPolicy"):
        SelectionSpec(spec.fn, 4, retry=3)


def test_circuit_breaker_transitions():
    clock = [0.0]
    br = CircuitBreaker(threshold=2, cooldown_s=10.0, clock=lambda: clock[0])
    assert br.allow() and br.state == "closed"
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clock[0] = 11.0
    assert br.allow() and br.state == "half_open"
    br.record_failure()
    assert br.state == "open"
    clock[0] = 22.0
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_breaker_board_labels_and_listener():
    seen = []
    board = BreakerBoard(threshold=1, cooldown_s=600.0)
    board.bind(lambda label, state: seen.append((label, state)))
    key = ("FacilityLocation", "kernel")
    assert board.allow(key)
    board.record_failure(key)
    assert not board.allow(key)
    assert seen == [("FacilityLocation/kernel", "open")]
    assert board.states() == {"FacilityLocation/kernel": "open"}


# -- the fault matrix: every boundary x {sync, async, session} -----------------


@pytest.mark.parametrize("route", ["sync", "async", "session"])
@pytest.mark.parametrize("site", ["dispatch", "padder", "kernel"])
def test_fault_matrix_every_rid_resolves_bit_identical(site, route):
    """A transient (times=1) fault at each boundary: every rid resolves to
    exactly one answer, bit-equal to its sequential solve."""
    rng = np.random.default_rng(3)
    use_kernel = site == "kernel"  # the kernel boundary needs a cuda-* backend
    specs = [_fl_spec(rng, 32, 4, use_kernel), _fl_spec(rng, 32, 3, use_kernel)]
    expected = [solve(s) for s in specs]  # outside the armed plan
    server = SelectionServer(retry_policy=POLICY)
    plan = FaultPlan([FaultSpec(site=site, times=1)])
    if route == "sync":
        rids = [server.submit_spec(s) for s in specs]
        with faults.inject(plan):
            out = server.flush()
        assert not server.take_failures()
        assert sorted(out) == sorted(rids)
        for rid, want in zip(rids, expected):
            same(out[rid], want)
            assert out[rid].attempts == 2 or site != "dispatch"
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
        want = solve(SelectionSpec(_fb(np.concatenate([f0, d1]), use_kernel), 5))
        same(upd.result, want)
        assert upd.selection == want.as_list()
    assert plan.counts()[0]["fired"] == 1
    assert server.metrics.counters["flush_errors"] >= 1
    assert server.metrics.counters["quarantined_total"] == 0


def test_fault_matrix_session_extend_boundary():
    """The session-extend fault fires BEFORE the delta is built: the stream
    is untouched, and a client retry absorbs the delta exactly once."""
    rng = np.random.default_rng(4)
    server = SelectionServer(retry_policy=POLICY)
    f0 = rng.uniform(0, 1, size=(12, 6)).astype(np.float32)
    d1 = rng.uniform(0, 1, size=(6, 6)).astype(np.float32)
    session = server.open_session(SelectionSpec(_fb(f0), 5), sid="sx")
    with faults.inject(FaultPlan([FaultSpec(site="session-extend", session="sx")])):
        with pytest.raises(InjectedFault):
            session.extend(features=d1)
        assert session._seq == 0
        upd = session.extend(features=d1)
    want = solve(SelectionSpec(_fb(np.concatenate([f0, d1])), 5))
    assert upd.seq == 1
    same(upd.result, want)
    jwant = jsolve(JSelectionSpec(JFeatureBased.from_features(np.concatenate([f0, d1]),
                                                              concave="sqrt"), 5))
    near_ref(upd.result, jwant, 1e-4)


# -- quarantine, isolation, fallback, timeout ---------------------------------


def test_poison_quarantined_without_repoisoning_group():
    rng = np.random.default_rng(5)
    server = SelectionServer(retry_policy=POLICY)
    sa, sb = _fl_spec(rng), _fl_spec(rng, budget=5)
    ra, rb = server.submit_spec(sa), server.submit_spec(sb)
    with faults.inject(FaultPlan([FaultSpec(site="dispatch", rid=ra, times=None)])):
        out = server.flush()
    assert rb in out and ra not in out
    same(out[rb], solve(sb))
    fails = server.take_failures()
    assert set(fails) == {ra}
    err = fails[ra]
    assert isinstance(err, RequestFailed) and err.reason == "quarantined"
    assert len(err.attempts) == POLICY.max_attempts
    assert err.attempts[0]["attempt"] == 1 and "InjectedFault" in err.attempts[0]["error"]
    assert server.take_failures() == {}
    assert server.metrics.counters["quarantined_total"] == 1


def test_kernel_breaker_trips_cuda_to_torch_fallback():
    """Persistent kernel faults open the (family, kernel) breaker; the port
    does not fall back to the torch sweeps: every request of the family's
    kernel waves fails typed (``"breaker_open"``, its history naming the
    kernel fault and then the breaker), while another family's requests in
    the same flush are served.  Once the cooldown has passed (on the
    board's clock) and the fault is gone, a probe wave closes the breaker
    and the answers equal the sequential kernel-route solves."""
    rng = np.random.default_rng(6)
    now = [0.0]
    specs = [_fl_spec(rng, use_kernel=True), _fl_spec(rng, budget=6, use_kernel=True)]
    other = SelectionSpec(pair("gc_kernel", rng, 24)[0], 4)
    board = BreakerBoard(threshold=1, cooldown_s=30.0, clock=lambda: now[0])
    server = SelectionServer(retry_policy=POLICY, breakers=board)
    rids = [server.submit_spec(s) for s in specs]
    rid_other = server.submit_spec(other)
    plan = FaultPlan([FaultSpec(site="kernel", family="FacilityLocation", backend="cuda-*",
                                times=None)])
    with faults.inject(plan):
        out = server.flush()
    assert set(out) == {rid_other}
    same(out[rid_other], solve(other))
    fails = server.take_failures()
    assert set(fails) == set(rids)
    for rid in rids:
        err = fails[rid]
        assert isinstance(err, RequestFailed) and err.reason == "breaker_open"
        assert "InjectedFault" in err.attempts[0]["error"]
        assert "BreakerOpen" in err.attempts[-1]["error"]
        assert "FacilityLocation/kernel" in str(err)
        assert isinstance(err.__cause__, BreakerOpen)
    assert plan.counts()[0]["fired"] == 1  # one kernel fault, then refusals
    assert server.breakers.states() == {"FacilityLocation/kernel": "open",
                                        "GraphCut/kernel": "closed"}
    assert server.stats.snapshot()["breakers"]["FacilityLocation/kernel"] == "open"
    assert server.stats.summary()["breaker_state"]["FacilityLocation/kernel"] == "open"
    assert server.metrics.counters["fallbacks_total"] == 0
    rid = server.submit_spec(specs[0])  # still open: refused again
    assert rid not in server.flush() and server.take_failures()[rid].reason == "breaker_open"
    now[0] = 31.0  # cooldown over, fault gone: the probe wave closes it
    rids = [server.submit_spec(s) for s in specs]
    out = server.flush()
    for rid, s in zip(rids, specs):
        same(out[rid], solve(s))
        assert out[rid].backend == "cuda-fl"
    assert server.breakers.states()["FacilityLocation/kernel"] == "closed"


def test_closed_breaker_serves_the_kernel_route_undegraded():
    rng = np.random.default_rng(7)
    spec = _fl_spec(rng, use_kernel=True)
    server = SelectionServer()
    (resp,) = server.select([spec])
    same(resp, solve(spec))
    assert resp.backend == "cuda-fl" and resp.attempts == 1
    assert server.breakers.states() == {"FacilityLocation/kernel": "closed"}


@pytest.mark.parametrize("cause", ["dispatch", "oom", "kernel_error"])
def test_only_kernel_faults_charge_the_kernel_breaker(cause, monkeypatch):
    """A dispatch fault or an out-of-memory error on a kernel wave leaves
    the kernel breaker closed (threshold 1); a kernel that fails to launch
    (KernelError) opens it.  Each request retries and is answered."""
    rng = np.random.default_rng(18)
    spec = _fl_spec(rng, use_kernel=True)
    server = SelectionServer(retry_policy=POLICY, breakers=BreakerBoard(threshold=1))
    rid = server.submit_spec(spec)
    if cause == "dispatch":
        with faults.inject(FaultPlan([FaultSpec(site="dispatch", times=1)])):
            out = server.flush()
    else:
        from repro_torch.core.optimizers import batched

        error = (KernelError("fl_gains kernel: CUDA error 700 (an illegal memory access)")
                 if cause == "kernel_error" else torch.OutOfMemoryError("CUDA out of memory"))
        run = batched.BatchedEngine.run
        calls = []

        def failing_once(self, *a, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise error
            return run(self, *a, **kw)

        monkeypatch.setattr(batched.BatchedEngine, "run", failing_once)
        out = server.flush()
        if cause == "kernel_error":  # open: the retry is refused, typed
            assert rid not in out
            assert server.take_failures()[rid].reason == "breaker_open"
            assert server.breakers.states() == {"FacilityLocation/kernel": "open"}
            return
    same(out[rid], solve(spec))
    assert out[rid].attempts == 2
    assert server.breakers.states() == {"FacilityLocation/kernel": "closed"}


def test_open_breaker_fails_typed_on_every_front_door():
    """Single-attempt flush: FlushError caused by BreakerOpen, the request
    re-enqueued; select() and solve(mode="served") raise the typed
    RequestFailed of their own request under a retry policy."""
    rng = np.random.default_rng(19)
    spec = _fl_spec(rng, use_kernel=True)
    board = BreakerBoard(threshold=1, cooldown_s=600.0)
    board.record_failure(("FacilityLocation", "kernel"))
    server = SelectionServer(breakers=board)
    rid = server.submit_spec(spec)
    with pytest.raises(FlushError, match="FacilityLocation/kernel") as ei:
        server.flush()
    assert isinstance(ei.value.__cause__, BreakerOpen)
    assert ei.value.failed_rids == [rid] and server.pending_count == 1
    assert server.cancel(rid)
    resilient = SelectionServer(retry_policy=POLICY, breakers=board)
    with pytest.raises(RequestFailed, match="breaker_open"):
        resilient.select([spec])
    with pytest.raises(RequestFailed, match="breaker_open"):
        solve(SelectionSpec(spec.fn, 4, retry=POLICY), mode="served", server=resilient)
    torch_spec = _fl_spec(rng)  # the torch route has no kernel breaker
    same(resilient.select([torch_spec])[0], solve(torch_spec))


def test_timeout_s_fails_typed_instead_of_retrying(monkeypatch):
    """The request's clock passes its timeout_s during the failed first
    attempt (the clock is replaced, so no race with the wall clock): it
    fails typed, with no retry."""
    now = [100.0]
    monkeypatch.setattr(coalesce, "clock", lambda: now[0])
    rng = np.random.default_rng(8)
    server = SelectionServer(
        retry_policy=RetryPolicy(max_attempts=100, backoff_s=0.0, jitter=0.0, timeout_s=0.5))
    rid = server.submit_spec(_fl_spec(rng))
    check = faults.check

    def slow_check(site, **attrs):  # the dispatch takes a second on the clock
        if site == "dispatch":
            now[0] += 1.0
        check(site, **attrs)

    monkeypatch.setattr(faults, "check", slow_check)
    with faults.inject(FaultPlan([FaultSpec(site="dispatch", times=1)])):
        out = server.flush()
    assert rid not in out
    fails = server.take_failures()
    assert fails[rid].reason == "timeout" and len(fails[rid].attempts) == 1


def test_timeout_reaps_a_queued_request_before_its_first_attempt(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(coalesce, "clock", lambda: now[0])
    rng = np.random.default_rng(9)
    server = SelectionServer(retry_policy=RetryPolicy(timeout_s=0.5))
    rid_old = server.submit_spec(_fl_spec(rng))
    now[0] += 0.75
    spec_new = _fl_spec(rng, budget=2)
    rid_new = server.submit_spec(spec_new)
    out = server.flush()
    assert set(out) == {rid_new}
    same(out[rid_new], solve(spec_new))
    fails = server.take_failures()
    assert fails[rid_old].reason == "timeout" and fails[rid_old].attempts == ()


def test_legacy_flush_error_contract_without_policy():
    rng = np.random.default_rng(10)
    server = SelectionServer()
    rid = server.submit_spec(_fl_spec(rng))
    with faults.inject(FaultPlan([FaultSpec(site="dispatch", times=1)])):
        with pytest.raises(FlushError) as ei:
            server.flush()
    assert ei.value.failed_rids == [rid]
    assert rid in server.flush()


def test_per_request_retry_policy_beats_server_default():
    rng = np.random.default_rng(11)
    server = SelectionServer(retry_policy=POLICY)
    rid = server.submit_spec(SelectionSpec(_fl_spec(rng).fn, 4, retry=SINGLE_ATTEMPT))
    with faults.inject(FaultPlan([FaultSpec(site="dispatch", times=None)])):
        out = server.flush()
    assert rid not in out
    fails = server.take_failures()
    assert fails[rid].reason == "quarantined" and len(fails[rid].attempts) == 1


def test_async_quarantine_resolves_future_with_typed_error():
    rng = np.random.default_rng(12)
    server = SelectionServer(retry_policy=POLICY)
    sa, sb = _fl_spec(rng), _fl_spec(rng, budget=5)
    with AsyncSelectionServer(server, max_pending=100, flush_interval=600.0) as front:
        fa = front.submit(sa)
        fb = front.submit(sb)
        ra = next(rid for rid, f in front._futures.items() if f is fa)
        with faults.inject(FaultPlan([FaultSpec(site="dispatch", rid=ra, times=None)])):
            front.flush_now()
        with pytest.raises(RequestFailed) as ei:
            fa.result(timeout=60)
        assert ei.value.reason == "quarantined"
        same(fb.result(timeout=60), solve(sb))
    assert server.metrics.counters["quarantined_total"] == 1


# -- crash-safe sessions: journal + restore -----------------------------------


def test_session_journal_restore_bit_identical_features(tmp_path):
    rng = np.random.default_rng(13)
    journal = SessionJournal(tmp_path / "journal")
    f0 = rng.uniform(0, 1, size=(16, 12)).astype(np.float32)
    spec = SelectionSpec(_fb(f0), 5)
    session = SelectionServer().open_session(spec, sid="alpha", journal=journal)
    for shape in [(8, 12), (4, 12), (2, 12)]:
        upd = session.extend(features=rng.uniform(0, 1, size=shape).astype(np.float32))
    restored = restore_sessions(SelectionServer(), journal, {"alpha": spec})
    r = restored["alpha"]
    assert r.sid == "alpha" and r._seq == 3 and r.mode == "features"
    assert r.last_update.selection == upd.selection
    same(r.last_update.result, upd.result)
    assert r.deltas_absorbed == 3 and r.churn_total == session.churn_total
    u4 = r.extend(features=rng.uniform(0, 1, size=(3, 12)).astype(np.float32))
    assert [d["seq"] for d in journal.deltas("alpha")] == [1, 2, 3, 4]
    assert u4.seq == 4


def test_session_journal_restore_indices_mode(tmp_path):
    rng = np.random.default_rng(14)
    journal = SessionJournal(tmp_path / "journal")
    spec = SelectionSpec(_fl_spec(rng, n=24).fn, 4)
    session = SelectionServer().open_session(spec, sid="idx", journal=journal)
    session.extend(indices=[3, 1, 8, 3])
    upd = session.extend(indices=[5, 2, 19, 11])
    r = restore_sessions(SelectionServer(), journal, {"idx": spec})["idx"]
    assert r.mode == "indices" and r._active == session._active
    assert r.last_update.selection == upd.selection


def test_restore_sessions_requires_base_spec(tmp_path):
    rng = np.random.default_rng(15)
    journal = SessionJournal(tmp_path / "journal")
    spec = SelectionSpec(_fb(rng.uniform(0, 1, size=(8, 4)).astype(np.float32)), 3)
    SelectionServer().open_session(spec, sid="orphan", journal=journal).extend(
        features=rng.uniform(0, 1, size=(2, 4)).astype(np.float32))
    with pytest.raises(KeyError, match="orphan"):
        restore_sessions(SelectionServer(), journal, {})


def test_journal_append_is_atomic_against_partial_step(tmp_path):
    rng = np.random.default_rng(16)
    journal = SessionJournal(tmp_path / "journal")
    spec = SelectionSpec(_fb(rng.uniform(0, 1, size=(8, 4)).astype(np.float32)), 3)
    s = SelectionServer().open_session(spec, sid="torn", journal=journal)
    s.extend(features=rng.uniform(0, 1, size=(2, 4)).astype(np.float32))
    (tmp_path / "journal" / "torn" / "step_0000000002.tmp").mkdir()
    assert [d["seq"] for d in journal.deltas("torn")] == [1]
    assert restore_sessions(SelectionServer(), journal, {"torn": spec})["torn"]._seq == 1


def test_checkpoint_round_trip_and_prune(tmp_path):
    from repro_torch.ckpt import checkpoint

    tree = {"payload": np.arange(6, dtype=np.float32).reshape(2, 3), "aux": {"ids": np.arange(3)}}
    for step in range(4):
        checkpoint.save(str(tmp_path), step, tree, meta={"k": step}, keep_last=2)
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000002", "step_0000000003"]
    back, meta = checkpoint.restore(str(tmp_path), {"payload": 0, "aux": {"ids": 0}}, step=2)
    np.testing.assert_array_equal(back["payload"], tree["payload"])
    np.testing.assert_array_equal(back["aux"]["ids"], tree["aux"]["ids"])
    assert meta == {"k": 2, "step": 2}
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), {"payload": 0})


# -- metrics: decorrelated reservoirs, resilience counters ---------------------


def test_histogram_reservoirs_are_decorrelated_per_metric():
    from repro_torch.launch.metrics import ServerMetrics

    m = ServerMetrics(reservoir_size=8)
    for v in range(512):
        m.queue_s.record(float(v))
        m.wave_s.record(float(v))
    a = sorted(m.queue_s._reservoir._sample)
    assert a != sorted(m.wave_s._reservoir._sample)
    m2 = ServerMetrics(reservoir_size=8)
    for v in range(512):
        m2.queue_s.record(float(v))
    assert sorted(m2.queue_s._reservoir._sample) == a


def test_resilience_counters_have_stable_keys():
    rng = np.random.default_rng(17)
    server = SelectionServer(retry_policy=POLICY)
    rid = server.submit_spec(_fl_spec(rng))
    with faults.inject(FaultPlan([FaultSpec(site="dispatch", times=1)])):
        out = server.flush()
    assert rid in out and out[rid].attempts == 2
    snap = server.stats.snapshot()
    assert snap["counters"]["retries_total"] == 1
    for key in ("retries_total", "fallbacks_total", "quarantined_total", "breaker_state"):
        assert key in server.stats.summary()
