"""Async selection serving: futures over the per-group coalescing server.

The JAX package's ``launch/async_serve.py``, ported.
:class:`AsyncSelectionServer` wraps a :class:`~repro_torch.launch.serve.SelectionServer`
with the flush triggers a latency-bounded deployment needs, evaluated
**per (family, n-bucket) group** — continuous batching, not a global flush:

- **queue depth**: the moment a group holds ``max_pending`` requests, THAT
  group flushes (throughput trigger) — other groups keep waiting for their
  own co-travellers;
- **timer**: a group flushes once its oldest request has waited
  ``flush_interval`` seconds, so a lone request is never stranded
  (latency trigger);
- **deadline**: a request whose spec carries ``deadline_s`` stops its group
  from waiting past that deadline (the scheduler dispatches at the deadline
  at the latest; wave wall time may still push completion past it, which is
  counted under ``deadline_misses`` and flagged on the response).

``submit(spec)`` returns a ``concurrent.futures.Future`` that resolves to
the request's :class:`~repro_torch.launch.serve.SelectionResponse` (await it from
asyncio via ``asyncio.wrap_future``).  With ``max_queue`` set on the server,
``submit`` applies **backpressure**: it raises
:class:`~repro_torch.launch.serve.ServerOverloaded` when the server is full, or —
with ``block=True`` — waits until a flush frees space.  Because requests
are already :class:`~repro_torch.core.optimizers.spec.SelectionSpec`
objects, the wrapper reuses the coalescer and the batched engine
**unchanged** — same waves, same padding, same bit-identical results as
synchronous serving and sequential ``solve()``.

    server = AsyncSelectionServer(max_pending=16, flush_interval=0.02)
    fut = server.submit(SelectionSpec(fn, budget))
    response = fut.result()          # [(index, gain), ...] in .selection
    server.close()                   # or use it as a context manager

Thread-safety and the lock discipline (the fix for head-of-line blocking):
the condition lock guards ONLY the queues and the futures map.  A flush
swaps the due groups' requests and futures out under the lock, then runs
the engine dispatch OUTSIDE it (serialized by a separate dispatch lock), so
``submit`` never blocks behind an executing wave — a submission arriving
mid-flush enqueues immediately and rides its group's next wave.

The flush thread launches the kernels on its current CUDA stream, the
legacy default stream (the server sets no stream of its own, and the port
asks for no per-thread default stream), so every tensor a submitting thread
built on that stream is ordered before the wave that reads it.

Failure discipline: an engine error mid-flush completes the poisoned wave's
futures exceptionally with the engine's original exception, re-enqueues
every never-dispatched request (futures intact — they ride the next flush),
and delivers the responses that did complete.  Corner case: a request
submitted directly on the wrapped *sync* server that lands in a poisoned
async wave has no future to complete and is not requeued — its loss is
reported only through ``flush_errors``; keep sync and async front ends on
separate servers if that matters.

Resilient mode: when the wrapped server carries a ``retry_policy`` (or any
spec its own ``retry``), dispatch runs the server's retry / poison-isolation
/ quarantine path instead — transient failures retry with backoff, and a
request that exhausts its budget resolves its future exceptionally with a
typed :class:`~repro_torch.launch.resilience.RequestFailed` (never a bare engine
error, never a stranded future).  Wave-build (padder) failures are always
handled resiliently here, whatever the policy: they fail the affected
requests typed instead of killing the flush thread.

On a mesh (``mesh=``, or a mesh ``server``) the triggers decide on rank 0
only: rank 0's flush thread drains and dispatches, each mesh wave's plan
and collectives issued from the dispatching thread under the dispatch
lock.  On every other rank the wrapper starts no thread and ``submit``
raises :class:`~repro_torch.launch.mesh_plane.FollowerError`: there the
wrapped server's ``follow()`` runs the waves rank 0 sends until rank 0's
``close()`` stops them.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future

from repro_torch.core.optimizers.spec import SelectionSpec
from repro_torch.launch import coalesce
from repro_torch.launch.serve import FlushError, SelectionServer


class AsyncSelectionServer:
    """Per-group depth / timer / deadline triggered flush wrapper around
    ``SelectionServer``.

    Args:
      server: an existing :class:`SelectionServer` to drive, or None to
        build one from ``mesh`` / ``max_wave`` / axis names.
      max_pending: flush a group as soon as it holds this many requests.
      flush_interval: flush a group whenever its OLDEST pending request has
        waited this many seconds (so a lone request is never stranded).
      max_queue: backpressure cap on total pending requests (sets the
        wrapped server's ``max_queue``); None leaves the server's own
        setting untouched.
      block: default for ``submit(..., block=)`` — True makes a full-queue
        submit wait for space instead of raising ``ServerOverloaded``.
      mesh, batch_axis, data_axis, max_wave, control_timeout: forwarded to
        the internal ``SelectionServer`` when ``server`` is None (every rank
        of a mesh builds it; ``close()`` on rank 0 then also stops the
        followers).
    """

    # the two-lock protocol: _cv guards the queues + futures map ONLY;
    # engine dispatch runs under _dispatch_lock with _cv released so new
    # submits never block behind a running wave
    _GUARDED_BY = {"_futures": "_cv", "_closed": "_cv"}

    def __init__(
        self,
        server: SelectionServer | None = None,
        *,
        max_pending: int = 16,
        flush_interval: float = 0.05,
        max_queue: int | None = None,
        block: bool = False,
        mesh=None,
        batch_axis: str = "batch",
        data_axis: str = "data",
        max_wave: int = 64,
        control_timeout=None,
    ):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if flush_interval <= 0:
            raise ValueError(
                f"flush_interval must be positive, got {flush_interval}"
            )
        self._owns_server = server is None
        self._server = (
            server
            if server is not None
            else SelectionServer(
                mesh=mesh,
                batch_axis=batch_axis,
                data_axis=data_axis,
                max_wave=max_wave,
                control_timeout=control_timeout,
            )
        )
        if max_queue is not None:
            if max_queue < 1:
                raise ValueError(f"max_queue must be >= 1 or None, got {max_queue}")
            self._server.max_queue = int(max_queue)
        self.max_pending = int(max_pending)
        self.flush_interval = float(flush_interval)
        self.block = bool(block)
        self._cv = threading.Condition()  # guards queues + futures map ONLY
        self._dispatch_lock = threading.Lock()  # serializes engine dispatch
        self._futures: dict = {}  # rid -> Future, for requests not yet drained
        self._closed = False
        self.flushes = 0  # completed (error-free) flush count
        self._thread = threading.Thread(
            target=self._loop, name="AsyncSelectionServer", daemon=True
        )
        if not self._server.is_follower:  # the triggers decide on rank 0 only
            self._thread.start()

    # -- client API ----------------------------------------------------------

    def submit(self, spec: SelectionSpec, rid=None, *, block: bool | None = None) -> Future:
        """Enqueue one :class:`SelectionSpec`; returns a Future resolving to
        its :class:`~repro_torch.launch.serve.SelectionResponse`.

        Validation is synchronous and immediate (unsupported family /
        non-batched optimizer raise HERE, exactly like
        ``SelectionServer.submit_spec``); only the dispatch is deferred to a
        flush trigger.  When the server is at ``max_queue``: raises
        :class:`~repro_torch.launch.serve.ServerOverloaded` (counted under
        ``rejections``), or with ``block=True`` waits until a flush frees
        space.  Awaitable from asyncio via ``asyncio.wrap_future``.
        """
        if block is None:
            block = self.block
        with self._cv:
            while True:
                if self._closed:
                    raise RuntimeError("AsyncSelectionServer is closed")
                cap = self._server.max_queue
                if not block or cap is None or self._server.pending_count < cap:
                    break
                self._cv.wait()  # a drain or cancel will notify
            rid = self._server.submit_spec(spec, rid=rid)
            fut: Future = Future()
            self._futures[rid] = fut
            self._cv.notify_all()  # triggers are evaluated in the loop
        return fut

    def open_session(self, spec: SelectionSpec, *, sid=None, journal=None):
        """Open a :class:`~repro_torch.launch.sessions.SelectionSession` whose
        ``extend`` returns Futures: each delta submits through this front
        end's triggers and resolves to a ``SessionUpdate`` when its wave
        lands.  ``close(flush=False)`` cancels in-flight delta futures;
        a full queue raises ``ServerOverloaded`` at ``extend`` time.
        ``sid`` / ``journal`` enable crash recovery, see
        :func:`~repro_torch.launch.sessions.restore_sessions`."""
        from repro_torch.launch.sessions import SelectionSession

        return SelectionSession(self, spec, sid=sid, journal=journal)

    def flush_now(self) -> None:
        """Drain every group and dispatch immediately in the calling thread
        (manual trigger).  Safe to race the timer: draining is atomic under
        the condition lock, so each request is dispatched exactly once —
        whoever drains it first owns it."""
        with self._cv:
            batch = self._drain_locked(None)
        if batch is not None:
            self._execute(batch)

    def close(self, flush: bool = True) -> None:
        """Stop the flush thread.  Pending futures are dispatched first when
        ``flush`` (default) — otherwise they are cancelled AND their
        requests removed from the wrapped server's queues (no orphans for a
        later sync ``flush()`` to trip over).  A wave already executing
        completes either way; its futures resolve normally.

        Order matters: the worker is JOINED before the final drain.  An
        in-flight ``_execute`` may, on a flush error, requeue undispatched
        requests and reinstate their futures — draining before the join
        would miss those and strand their futures forever.  The final drain
        loops until the queues are empty for the same reason: the close-time
        dispatch itself may requeue."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()  # wake the loop and any blocked submitters
        if self._server.is_follower:
            return
        try:
            self._close(flush)
        finally:
            if self._owns_server:
                self._server.close()  # on a mesh: stop the followers

    def _close(self, flush: bool) -> None:
        self._thread.join()  # an in-flight _execute finishes (and may requeue)
        if flush:
            while True:
                with self._cv:
                    batch = self._drain_locked(None)
                if batch is None:
                    break
                self._execute(batch)
        else:
            with self._cv:
                for rid, fut in self._futures.items():
                    fut.cancel()
                    self._server.cancel(rid)
                self._futures.clear()
                self._cv.notify_all()

    def __enter__(self) -> "AsyncSelectionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._futures)

    @property
    def stats(self):
        """The wrapped server's aggregate accounting."""
        return self._server.stats

    @property
    def metrics(self):
        """The wrapped server's structured metric tree."""
        return self._server.metrics

    # -- flush machinery -----------------------------------------------------

    def _due_groups(self, now: float):
        """(due group keys, earliest future trigger time).  A group is due
        when its depth hits ``max_pending`` or ``now`` reached its trigger —
        the oldest member's ``enqueue_t + flush_interval``, pulled earlier
        by the group's earliest deadline."""
        due, wake_at = [], None
        for key, depth, oldest_t, deadline_t in self._server.group_states():
            trigger_t = oldest_t + self.flush_interval
            if deadline_t is not None:
                trigger_t = min(trigger_t, deadline_t)
            if depth >= self.max_pending or now >= trigger_t:
                due.append(key)
            elif wake_at is None or trigger_t < wake_at:
                wake_at = trigger_t
        return due, wake_at

    def _drain_locked(self, keys):
        """Swap the due groups' requests and futures out of shared state.
        Caller holds the condition lock.  Returns ``(waves, futures)`` or
        None when nothing was pending.

        Always drains via the server's resilient path: a wave-build (padder)
        error costs one group — its exhausted requests fail their futures
        typed HERE, its retryable ones stay queued for a later trigger —
        instead of raising out of the flush thread's loop and killing it.
        Without any retry policy the behavior is single-attempt (immediate
        typed failure), so the legacy dispatch contract is unchanged."""
        waves, _, failures, _ = self._server.drain_resilient(
            keys, take_undelivered=False
        )
        sync_owned = {}
        for rid, err in failures.items():
            fut = self._futures.pop(rid, None)
            if fut is None:
                sync_owned[rid] = err  # sync submitter: surfaces take_failures
            elif not fut.cancelled():
                fut.set_exception(err)
        if sync_owned:
            self._server.hold_failures(sync_owned)
        if not waves:
            if failures:
                self._cv.notify_all()  # queue space freed by the reap
            return None
        futures = {}
        for wave in waves:
            for req in wave.requests:
                fut = self._futures.pop(req.rid, None)
                if fut is not None:
                    futures[req.rid] = fut
        self._cv.notify_all()  # queue space freed: wake blocked submitters
        return waves, futures

    def _execute(self, batch) -> None:
        """Dispatch drained waves OUTSIDE the condition lock and complete
        their futures.  The dispatch lock serializes engine use across the
        flush thread, ``flush_now`` callers, and ``close``.

        With a retry policy in play (server-wide or on any rider's spec)
        this runs the server's resilient dispatch: transient failures retry
        with backoff inside the dispatch lock, exhausted requests resolve
        their futures with typed
        :class:`~repro_torch.launch.resilience.RequestFailed`.  Otherwise the
        legacy single-attempt :class:`FlushError` discipline applies
        unchanged."""
        waves, futures = batch
        resilient = self._server.retry_policy is not None or any(
            req.spec.retry is not None for w in waves for req in w.requests
        )
        if resilient:
            try:
                with self._dispatch_lock:
                    responses, failures = self._server.dispatch_resilient(waves)
            except BaseException as e:  # never strand a future
                for fut in futures.values():
                    if not fut.cancelled():
                        fut.set_exception(e)
                return
            sync_owned = {}
            for rid, err in failures.items():
                fut = futures.pop(rid, None)
                if fut is None:
                    sync_owned[rid] = err
                elif not fut.cancelled():
                    fut.set_exception(err)
            if sync_owned:
                with self._cv:
                    self._server.hold_failures(sync_owned)
            self.flushes += 1
            self._complete(responses, futures)
            return
        try:
            with self._dispatch_lock:
                responses = self._server.dispatch_waves(waves)
        except FlushError as e:
            self._complete_partial(e, futures)
            return
        except BaseException as e:  # complete ALL futures, never strand one
            for fut in futures.values():
                if not fut.cancelled():
                    fut.set_exception(e)
            return
        self.flushes += 1
        self._complete(responses, futures)

    def _complete(self, responses: dict, futures: dict) -> None:
        for rid, fut in futures.items():
            resp = responses.pop(rid, None)
            if fut.cancelled():
                continue
            if resp is not None:
                fut.set_result(resp)
            else:  # cannot happen while dispatch returns every rid; be loud
                fut.set_exception(
                    KeyError(f"flush returned no response for rid {rid!r}")
                )
        if responses:
            # requests enqueued directly on the wrapped sync server rode this
            # flush; re-hold their responses for the sync caller's flush()
            with self._cv:
                self._server.hold_undelivered(responses)

    def _complete_partial(self, e: FlushError, futures: dict) -> None:
        """An engine error mid-dispatch: deliver what completed, requeue
        what never ran (futures intact), and fail the poisoned wave's
        futures with the engine's own exception."""
        responses = dict(e.completed)
        for rid in list(futures):
            if rid in responses:
                fut = futures.pop(rid)
                resp = responses.pop(rid)
                if not fut.cancelled():
                    fut.set_result(resp)
        with self._cv:
            if responses:  # sync-owned responses that completed
                self._server.hold_undelivered(responses)
            if e.undispatched_requests:
                self._server.requeue(e.undispatched_requests)
                for req in e.undispatched_requests:
                    fut = futures.pop(req.rid, None)
                    if fut is not None:
                        self._futures[req.rid] = fut  # rides the next flush
            self._cv.notify_all()
        # what remains is the poisoned wave: complete exceptionally with the
        # engine's cause (NOT requeued — retrying a poisoned wave forever
        # would livelock the timer; the client decides whether to resubmit)
        cause = e.__cause__ or e
        for fut in futures.values():
            if not fut.cancelled():
                fut.set_exception(cause)

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                now = coalesce.clock()
                due, wake_at = self._due_groups(now)
                if not due:
                    timeout = None if wake_at is None else max(0.0, wake_at - now)
                    self._cv.wait(timeout=timeout)
                    continue
                batch = self._drain_locked(due)
            if batch is not None:
                self._execute(batch)
