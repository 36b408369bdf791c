"""The port's AsyncSelectionServer (``repro_torch.launch.async_serve``) on
the CPU: flush triggers, futures, backpressure, deadlines, failure
discipline and session deltas, every async answer bit-equal to the port's
sequential ``solve(spec)`` (ids, gains, ``n_evals``, value).

Mirrors tests/test_async_serve.py; the specs are built from the same numpy
draws as there, and the mixed workload is also held to the JAX package's
sequential solves.
"""
import asyncio
import threading
import time
import warnings

import numpy as np
import pytest

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import SelectionSpec as JSelectionSpec
from repro.core import create_kernel as jcreate_kernel
from repro.core import solve as jsolve
from repro_torch.core import FacilityLocation, FeatureBased, GraphCut, SelectionSpec, solve
from repro_torch.launch.async_serve import AsyncSelectionServer
from repro_torch.launch.serve import SelectionServer, ServerOverloaded

from _torch_serving_pairs import CPU, near_ref
from _torch_serving_pairs import same as _same_bits


def _kernel(rng, n):
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return np.asarray(jcreate_kernel(x, metric="euclidean"))


def _spec(rng, n=32, budget=4, optimizer="NaiveGreedy", **kw):
    S = _kernel(rng, n)
    return SelectionSpec(FacilityLocation.from_kernel(S, device=CPU), budget, optimizer, **kw)


def _same(seq, resp):
    _same_bits(resp, seq)


def test_queue_depth_trigger_flushes_without_timer(rng):
    """max_pending reached -> flush, even though the timer is far away."""
    specs = [_spec(rng) for _ in range(3)]
    with AsyncSelectionServer(max_pending=3, flush_interval=600.0) as server:
        t0 = time.monotonic()
        futures = [server.submit(s) for s in specs]
        responses = [f.result(timeout=300) for f in futures]
        assert time.monotonic() - t0 < 600  # did not wait for the timer
        assert server.flushes >= 1
    for s, r in zip(specs, responses):
        _same(solve(s), r)
    # depth-triggered requests coalesce: same-shape specs rode ONE wave
    assert responses[0].wave_size == 3


def test_timer_trigger_flushes_lone_request(rng):
    """A lone request must not be stranded below max_pending."""
    spec = _spec(rng)
    with AsyncSelectionServer(max_pending=100, flush_interval=0.05) as server:
        fut = server.submit(spec)
        resp = fut.result(timeout=300)  # timer fires, future completes
        assert server.flushes >= 1
    _same(solve(spec), resp)


def test_flush_now_manual_trigger(rng):
    spec = _spec(rng)
    with AsyncSelectionServer(max_pending=100, flush_interval=600.0) as server:
        fut = server.submit(spec)
        assert server.pending == 1
        server.flush_now()
        assert server.pending == 0
        _same(solve(spec), fut.result(timeout=60))


def test_mixed_workload_bit_identical(rng):
    """Heterogeneous specs (sizes, budgets, optimizers) through the async
    front end: every response equals the port's sequential solve bit for
    bit, and the JAX package's sequential solve over the same kernel (ids,
    n_evals, gains to 1e-5), the off-bucket n=24 request too.  The three
    specs land in three groups, each flushed by its own timer trigger."""
    cases = [(32, 4, "NaiveGreedy", {}), (32, 6, "LazyGreedy", {"screen_k": 4}),
             (24, 3, "NaiveGreedy", {})]
    kernels = [_kernel(rng, n) for n, *_ in cases]
    specs = [SelectionSpec(FacilityLocation.from_kernel(S, device=CPU), b, opt, **kw)
             for S, (_, b, opt, kw) in zip(kernels, cases)]
    with AsyncSelectionServer(max_pending=len(specs),
                              flush_interval=0.05) as server:
        futures = [server.submit(s) for s in specs]
        responses = [f.result(timeout=300) for f in futures]
    for s, r, S, (_, b, opt, kw) in zip(specs, responses, kernels, cases):
        _same(solve(s), r)
        near_ref(r, jsolve(JSelectionSpec(JFacilityLocation.from_kernel(S), b, opt, **kw)), 1e-5)


def test_close_flushes_pending(rng):
    spec = _spec(rng)
    server = AsyncSelectionServer(max_pending=100, flush_interval=600.0)
    fut = server.submit(spec)
    server.close()  # default: drain, don't strand
    _same(solve(spec), fut.result(timeout=0))
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(spec)
    server.close()  # idempotent


def test_close_without_flush_cancels(rng):
    server = AsyncSelectionServer(max_pending=100, flush_interval=600.0)
    fut = server.submit(_spec(rng))
    server.close(flush=False)
    assert fut.cancelled()


def test_submit_validation_is_synchronous(rng):
    """Bad requests fail in the caller, immediately — same rejections as the
    sync server — and never consume a future or poison a flush."""
    from repro_torch.core import DisparityMinSum

    d = rng.uniform(0.1, 1.0, size=(8, 8)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    with AsyncSelectionServer(max_pending=100, flush_interval=600.0) as server:
        with pytest.raises(NotImplementedError, match="register_padder"):
            server.submit(SelectionSpec(DisparityMinSum.from_distance(d, device=CPU), 2))
        with pytest.raises(ValueError, match="batched-capable"):
            server.submit(_spec(rng, optimizer="StochasticGreedy"))
        ok = server.submit(_spec(rng))
        server.flush_now()
        assert ok.result(timeout=60).selection


def test_flush_failure_propagates_to_futures(rng):
    """A dispatch error must complete every pending future exceptionally —
    a stranded future is a hung client.  The engine's ORIGINAL exception is
    what surfaces (via FlushError.__cause__), not a serving wrapper."""
    class Boom(RuntimeError):
        pass

    class ExplodingServer(SelectionServer):
        def _dispatch(self, wave):
            raise Boom("engine on fire")

    with AsyncSelectionServer(ExplodingServer(), max_pending=100,
                              flush_interval=600.0) as server:
        fut = server.submit(_spec(rng))
        server.flush_now()
        with pytest.raises(Boom):
            fut.result(timeout=60)


def test_wrapped_server_sync_requests_are_not_dropped(rng):
    """Wrapping an existing SelectionServer that already has a sync request
    pending: the async flush answers it too, and must re-hold its response
    for the sync caller's own flush() instead of discarding it."""
    sync = SelectionServer()
    early = _spec(rng, n=16, budget=3)
    rid_early = sync.submit_spec(early)
    with AsyncSelectionServer(sync, max_pending=100,
                              flush_interval=600.0) as front:
        fut = front.submit(_spec(rng, n=24, budget=4))
        front.flush_now()
        assert fut.result(timeout=60).selection
        held = sync.flush()  # the sync request's answer surfaces here
        _same(solve(early), held[rid_early])


def test_futures_are_awaitable(rng):
    spec = _spec(rng)

    async def roundtrip(server):
        return await asyncio.wrap_future(server.submit(spec))

    with AsyncSelectionServer(max_pending=1, flush_interval=600.0) as server:
        resp = asyncio.run(roundtrip(server))
    _same(solve(spec), resp)


def test_constructor_validation():
    with pytest.raises(ValueError, match="max_pending"):
        AsyncSelectionServer(max_pending=0)
    with pytest.raises(ValueError, match="flush_interval"):
        AsyncSelectionServer(flush_interval=0.0)


def test_async_path_emits_no_deprecation_warnings(rng):
    spec = _spec(rng)
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        with AsyncSelectionServer(max_pending=1) as server:
            server.submit(spec).result(timeout=300)
    assert not [w for w in record if issubclass(w.category, DeprecationWarning)]


# ---------------------------------------------------------------------------
# Per-group continuous batching, backpressure, deadlines, failure discipline.
# ---------------------------------------------------------------------------


def test_per_group_depth_trigger_flushes_only_that_group(rng):
    """The depth trigger is per (family, n-bucket) group: two same-shape
    requests flush the moment their group fills, while a request in another
    group keeps waiting for ITS co-travellers — continuous batching, not a
    global flush."""
    fl_specs = [_spec(rng, n=32) for _ in range(2)]
    other = _spec(rng, n=24)  # different padded shapes -> different group
    with AsyncSelectionServer(max_pending=2, flush_interval=600.0) as server:
        f_other = server.submit(other)
        futures = [server.submit(s) for s in fl_specs]
        responses = [f.result(timeout=300) for f in futures]
        assert all(r.wave_size == 2 for r in responses)
        assert not f_other.done()  # its group never hit the depth trigger
        server.flush_now()
        r_other = f_other.result(timeout=300)
        assert r_other.wave_size == 1
    for s, r in zip(fl_specs, responses):
        _same(solve(s), r)
    # the n=24 request pads to its 32 bucket, yet ids/gains AND n_evals are
    # bit-identical to sequential solve — engines count logical evaluations
    _same(solve(other), r_other)


def test_submit_does_not_block_behind_executing_wave(rng):
    """The head-of-line-blocking fix: dispatch runs OUTSIDE the condition
    lock, so a submit arriving mid-wave returns immediately instead of
    waiting out the wave's wall time."""
    started, release = threading.Event(), threading.Event()

    class SlowServer(SelectionServer):
        def _dispatch(self, wave):
            started.set()
            assert release.wait(timeout=60)
            return super()._dispatch(wave)

    with AsyncSelectionServer(SlowServer(), max_pending=1,
                              flush_interval=600.0) as server:
        f1 = server.submit(_spec(rng))
        assert started.wait(timeout=60)  # wave 1 is now executing
        t0 = time.monotonic()
        f2 = server.submit(_spec(rng))
        submit_s = time.monotonic() - t0
        release.set()
        assert submit_s < 1.0, f"submit blocked {submit_s:.2f}s behind the wave"
        assert f1.result(timeout=300).selection
        assert f2.result(timeout=300).selection


def test_deadline_pulls_flush_ahead_of_interval(rng):
    """A spec-level deadline_s caps how long its group waits for
    co-travellers: the flush fires at the deadline, far ahead of a long
    flush_interval."""
    spec = _spec(rng, deadline_s=0.2)
    with AsyncSelectionServer(max_pending=100, flush_interval=600.0) as server:
        t0 = time.monotonic()
        resp = server.submit(spec).result(timeout=300)
        waited = time.monotonic() - t0
    assert waited < 60, f"deadline did not pull the flush ({waited:.1f}s)"
    assert resp.queue_s < 60
    assert isinstance(resp.deadline_missed, bool)
    _same(solve(spec), resp)


def test_submit_backpressure_rejects_then_recovers(rng):
    with AsyncSelectionServer(max_pending=100, flush_interval=600.0,
                              max_queue=2) as server:
        a, b = server.submit(_spec(rng)), server.submit(_spec(rng))
        with pytest.raises(ServerOverloaded):
            server.submit(_spec(rng))
        assert server.stats.rejections == 1
        server.flush_now()  # drains the queue: space again
        c = server.submit(_spec(rng))
        server.flush_now()
        assert all(f.result(timeout=300).selection for f in (a, b, c))


def test_submit_block_waits_for_queue_space(rng):
    """block=True turns a full-queue rejection into a wait: the submit
    parks on the condition until a drain frees space, then enqueues."""
    with AsyncSelectionServer(max_pending=2, flush_interval=600.0,
                              max_queue=2) as server:
        a, b = server.submit(_spec(rng)), server.submit(_spec(rng))
        # the depth trigger (2 pending in one group) is already draining;
        # this submit waits for that drain instead of raising
        c = server.submit(_spec(rng), block=True)
        server.flush_now()
        assert all(f.result(timeout=300).selection for f in (a, b, c))
    assert server.stats.rejections == 0


def test_poisoned_wave_fails_its_futures_and_requeues_the_rest(rng):
    """Failure discipline across a multi-group flush: the completed wave
    delivers, the poisoned wave's future raises the engine's own error, and
    the never-dispatched request is requeued with its future intact — zero
    requests and zero computed responses lost."""
    class Boom(RuntimeError):
        pass

    class PoisonServer(SelectionServer):
        def _dispatch(self, wave):
            if wave.n_bucket == 64:
                raise Boom("poisoned wave")
            return super()._dispatch(wave)

    good, poison, late = _spec(rng, n=32), _spec(rng, n=64), _spec(rng, n=16)
    with AsyncSelectionServer(PoisonServer(), max_pending=100,
                              flush_interval=600.0) as server:
        f_good = server.submit(good)
        f_poison = server.submit(poison)
        f_late = server.submit(late)
        server.flush_now()
        _same(solve(good), f_good.result(timeout=300))  # completed: delivered
        with pytest.raises(Boom):
            f_poison.result(timeout=60)  # poisoned: the engine's own error
        assert not f_late.done()  # undispatched: requeued, future intact
        assert server.pending == 1
        server.flush_now()  # the poison is gone; the survivor now serves
        _same(solve(late), f_late.result(timeout=300))
        m = server.metrics.counters
        assert m["flush_errors"] == 1
        assert m["requeued"] == 1


def test_close_without_flush_cancels_and_clears_server_queues(rng):
    """close(flush=False) under multiple pending submits: every future is
    cancelled AND the requests leave the wrapped server's queues — a later
    sync flush() must not find orphans."""
    sync = SelectionServer()
    server = AsyncSelectionServer(sync, max_pending=100, flush_interval=600.0)
    futures = [server.submit(_spec(rng)) for _ in range(3)]
    server.close(flush=False)
    assert all(f.cancelled() for f in futures)
    assert sync.pending_count == 0
    assert sync.flush() == {}


def test_flush_now_races_timer_without_double_dispatch(rng):
    """flush_now racing the timer trigger: draining is atomic under the
    condition lock, so each request dispatches exactly once no matter who
    wins."""
    specs = [_spec(rng) for _ in range(6)]
    with AsyncSelectionServer(max_pending=100, flush_interval=0.01) as server:
        futures = []
        for s in specs:
            futures.append(server.submit(s))
            server.flush_now()  # races the 10 ms timer
        responses = [f.result(timeout=300) for f in futures]
    assert server.stats.requests == len(specs)  # exactly once each
    for s, r in zip(specs, responses):
        _same(solve(s), r)


def test_close_wakes_blocked_submitter(rng):
    """A submitter parked on block=True backpressure must not hang when the
    server closes underneath it — it raises instead."""
    server = AsyncSelectionServer(max_pending=100, flush_interval=600.0,
                                  max_queue=1)
    first = server.submit(_spec(rng))
    errors = []

    def blocked_submit():
        try:
            server.submit(_spec(rng), block=True)
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=blocked_submit)
    t.start()
    time.sleep(0.1)  # let it park on the condition
    server.close(flush=False)
    t.join(timeout=60)
    assert not t.is_alive()
    assert len(errors) == 1 and "closed" in str(errors[0])
    assert first.cancelled()


# ---------------------------------------------------------------------------
# Session deltas over the async front end (launch/sessions.py edge cases).
# ---------------------------------------------------------------------------


def _session_spec(rng, n0=4, budget=3, **kw):
    rows = rng.uniform(0.0, 1.0, size=(n0, 6)).astype(np.float32)
    return rows, SelectionSpec(FeatureBased.from_features(rows, device=CPU), budget, **kw)


def test_session_extend_races_flush_now_without_double_dispatch(rng):
    """extend() racing flush_now and a hot timer: a delta's rebuilt spec
    rides exactly one wave (drain is atomic), and the final update is still
    bit-identical to one solve() over the concatenated stream."""
    seed, spec = _session_spec(rng)
    deltas = [rng.uniform(0.0, 1.0, size=(3, 6)).astype(np.float32)
              for _ in range(5)]
    with AsyncSelectionServer(max_pending=100, flush_interval=0.01) as server:
        session = server.open_session(spec)
        updates = []
        for d in deltas:
            fut = session.extend(features=d)
            server.flush_now()  # races the 10 ms timer
            updates.append(fut.result(timeout=300))
        session.close()
    assert server.stats.requests == len(deltas)  # exactly once each
    full = np.concatenate([seed] + deltas, axis=0)
    direct = solve(SelectionSpec(FeatureBased.from_features(full, device=CPU),
                                 spec.budget))
    _same(direct, updates[-1].response)


def test_close_without_flush_cancels_session_delta_futures(rng):
    """close(flush=False) with a session delta in flight: the chained
    SessionUpdate future is cancelled, not stranded — result() raises."""
    from concurrent.futures import CancelledError

    _, spec = _session_spec(rng)
    server = AsyncSelectionServer(max_pending=100, flush_interval=600.0)
    session = server.open_session(spec)
    fut = session.extend(features=np.ones((2, 6), np.float32))
    server.close(flush=False)
    assert fut.cancelled()
    with pytest.raises(CancelledError):
        fut.result(timeout=0)


def test_session_extend_hits_backpressure_and_recovers(rng):
    """ServerOverloaded on a delta submission surfaces synchronously at
    extend() time, the session stream stays uncommitted (no double-append),
    and a retry after a flush replays the SAME stream as a clean session."""
    seed, spec = _session_spec(rng)
    d1 = rng.uniform(0.0, 1.0, size=(3, 6)).astype(np.float32)
    d2 = rng.uniform(0.0, 1.0, size=(3, 6)).astype(np.float32)
    with AsyncSelectionServer(max_pending=100, flush_interval=600.0,
                              max_queue=1) as server:
        session = server.open_session(spec)
        f1 = session.extend(features=d1)
        with pytest.raises(ServerOverloaded):
            session.extend(features=d2)  # queue full: rejected HERE
        assert server.stats.rejections == 1
        server.flush_now()
        assert f1.result(timeout=300).n_total == seed.shape[0] + 3
        f2 = session.extend(features=d2)  # retry: delta appended ONCE
        server.flush_now()
        upd = f2.result(timeout=300)
        session.close()
    assert upd.n_total == seed.shape[0] + 6
    full = np.concatenate([seed, d1, d2], axis=0)
    direct = solve(SelectionSpec(FeatureBased.from_features(full, device=CPU),
                                 spec.budget))
    _same(direct, upd.response)


def test_close_joins_worker_before_final_drain(rng):
    """Regression: close(flush=True) used to drain while an in-flight
    _execute was still running on the worker thread. If that execute then
    failed its wave, _complete_partial reinstated requests AFTER close's
    final drain had already run — stranding their futures forever. close()
    must join the worker FIRST, then drain, so the final drain sees every
    requeued request."""
    class Boom(RuntimeError):
        pass

    started = threading.Event()
    release = threading.Event()

    class BlockingPoison(SelectionServer):
        def _dispatch(self, wave):
            if wave.n_bucket == 64:
                started.set()
                assert release.wait(timeout=60)
                raise Boom("poisoned wave")
            return super()._dispatch(wave)

    fl = _spec(rng, n=64)
    gc = SelectionSpec(GraphCut.from_kernel(_kernel(rng, 24), lam=0.3, device=CPU), 4)

    server = AsyncSelectionServer(BlockingPoison(), max_pending=100,
                                  flush_interval=0.01)
    fut_fl = server.submit(fl)
    assert started.wait(timeout=60)  # worker is inside _execute now
    fut_gc = server.submit(gc)  # queued behind the in-flight wave

    closer = threading.Thread(target=server.close)  # flush=True
    closer.start()
    while not server._closed:  # close() has signalled shutdown...
        time.sleep(0.001)
    release.set()  # ...and only now may the in-flight execute fail
    closer.join(timeout=60)
    assert not closer.is_alive()

    with pytest.raises(Boom):
        fut_fl.result(timeout=60)  # poisoned: typed failure, not stranded
    _same(solve(gc), fut_gc.result(timeout=60))  # survivor: served by close
