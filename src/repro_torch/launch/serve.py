"""Selection serving: a coalescing front door over the batched engine.

The JAX package's ``launch/serve.py``, ported.  Clients submit selection
requests — :class:`~repro_torch.core.optimizers.spec.SelectionSpec`
objects, the same typed request the whole library runs on — and the server
answers them in **waves**:

  submit()  ->  per-(family, n-bucket) pending queue  [continuous batching]
  flush()   ->  drain queues into padded waves
            ->  one batched-engine dispatch per wave (on the functions'
                device: the card, or the CPU for functions built there)
            ->  demultiplex per-request responses + structured metrics

Requests queue **per group** (the coalescer's :func:`~repro_torch.launch.
coalesce.group_key`, computed shape-only at submit time), so a front end can
flush one hot group the moment it fills while a cold group keeps waiting
for co-travellers.  ``submit`` applies **backpressure**: when ``max_queue``
requests are already pending, it raises :class:`ServerOverloaded` instead
of letting the queue grow without bound.  Specs may carry a ``deadline_s``;
the async front end flushes a group early to honor the earliest deadline,
and responses report whether theirs was missed.

Failure discipline: a mid-flush engine error raises :class:`FlushError`
carrying the exact partition of the work — already-computed responses are
re-held for the next flush, never-dispatched requests are re-enqueued at
the front of their queues, and only the poisoned wave's requests are named
as failed (and also re-enqueued by ``flush()``, so the caller can ``cancel``
them or retry).  Nothing is ever dropped.

Results are bit-identical to sequential ``solve(spec)`` per request (ids,
gains, ``n_evals``, value; ``tests/test_torch_serving.py`` and
``chip_smoke.py`` phase 11 pin this): zero-padding adds zero-gain
candidates that the ``valid`` mask blocks, a padded family sums a candidate
in an order that does not depend on the padded size (the FL family is not
padded at all, see ``coalesce.bucket_for``), the padder keeps each request
on the backend its sequential solve takes, and a member whose budget is
spent stays frozen while its wave runs on.  No wave is ever served off the
kernels its sequential solves take: an open kernel breaker refuses the wave
(:class:`~repro_torch.launch.resilience.BreakerOpen`) instead.

**On a mesh** (``mesh=`` from ``distributed.make_mesh``; every rank builds
the server, in the same order) the waves run on the sharded engine, batch
over ``batch_axis`` and candidates over ``data_axis``; the coalescer rounds
each n up to the data axis and pads each batch to the batch axis
(``coalesce.py``).  Rank 0 is the front door and the other ranks follow the
waves it sends (``launch/mesh_plane.py``: the control plane, its idle
headers and why a failure inside a wave's collectives is fatal,
:class:`~repro_torch.launch.mesh_plane.MeshFailed`).  A wave the mesh
refuses before it runs (a family without a shard rule, a ``use_kernel=True``
GraphCut / DisparitySum / DisparityMin) or an injected dispatch fault on
the mesh charges the ``(family, "mesh")`` breaker; while that breaker is
open, the family's waves are served on rank 0's card alone, on the same
kernels, and every such response says ``degraded="single-device"``
(counted in ``fallbacks_total``).

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 16
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh 2x2

``launch/metrics.py`` has the metrics schema.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.optimizers.backends import backend_name
from repro_torch.core.optimizers.batched import BatchedEngine
from repro_torch.core.optimizers.spec import (
    SelectionSpec,
    resolve_optimizer,
    wave_capable_names,
)
from repro_torch.kernels._build import KernelError
from repro_torch.launch import coalesce, faults
from repro_torch.launch.coalesce import (
    SelectionRequest,
    Wave,
    group_key,
    group_label,
    waves_for_group,
)
from repro_torch.launch.mesh_plane import FollowerError, MeshFailed, MeshPlane
from repro_torch.launch.metrics import ServerMetrics
from repro_torch.launch.resilience import (
    SINGLE_ATTEMPT,
    BreakerBoard,
    BreakerOpen,
    RequestFailed,
    RetryPolicy,
)


class ServerOverloaded(RuntimeError):
    """``submit`` refused: the server already holds ``max_queue`` pending
    requests.  Retry after a flush drains the queue, raise ``max_queue``, or
    (async front end) submit with ``block=True`` to wait for space."""


class FlushError(RuntimeError):
    """An engine dispatch failed mid-flush.

    Carries the exact partition of the flush's work so no request and no
    computed response is ever lost:

    - ``completed``: {rid: response} for waves that finished BEFORE the
      failure (``flush()`` re-holds these for its next call);
    - ``failed_requests``: the poisoned wave's requests (``flush()``
      re-enqueues them at the front of their queue — ``cancel(rid)`` them
      before retrying if the poison is the request itself);
    - ``undispatched_requests``: requests whose waves never ran
      (``flush()`` re-enqueues them, original arrival stamps intact).

    ``__cause__`` is the engine's original exception.
    """

    def __init__(
        self,
        message: str,
        *,
        completed: dict,
        failed_requests: list,
        undispatched_requests: list,
    ):
        super().__init__(message)
        self.completed = completed
        self.failed_requests = failed_requests
        self.undispatched_requests = undispatched_requests

    @property
    def failed_rids(self) -> list:
        return [r.rid for r in self.failed_requests]

    @property
    def undispatched_rids(self) -> list:
        return [r.rid for r in self.undispatched_requests]


@dataclasses.dataclass
class SelectionResponse:
    """Answer to one request, plus where/how it was served.

    Latency accounting is truthful and decomposed: ``queue_s`` is how long
    THIS request waited for co-travellers (submit -> its wave's dispatch
    start), ``wave_s`` is the wave's dispatch wall time (shared by the
    wave), and ``latency_s`` is their sum — what the client observed.  A
    request that waited 500 ms for a 10 ms wave reports 510 ms, not 10.
    """

    rid: int | str
    selection: list  # [(index, gain), ...] in pick order, true-n index space
    result: object  # the per-request GreedyResult (== sequential solve)
    wave_size: int  # real requests in the wave that served this
    n_bucket: int  # ground-set size of that wave (coalesce.bucket_for)
    backend: str  # gain-sweep backend that answered ("torch", "cuda-fl", ...)
    latency_s: float  # client-observed: queue_s + wave_s
    queue_s: float = 0.0  # submit -> wave dispatch start (this request's wait)
    wave_s: float = 0.0  # wave dispatch wall time (shared by the wave)
    deadline_missed: bool = False  # delivered after the spec's deadline_s
    attempts: int = 1  # dispatch attempts this request survived (retries + 1)
    degraded: Optional[str] = None  # "single-device": an open mesh breaker rerouted it


class ServerStats:
    """Aggregate accounting across flushes — a bounded-memory view over
    :class:`~repro_torch.launch.metrics.ServerMetrics`.

    Replaces the old unbounded ``wave_seconds`` list: totals are exact
    (count / sum / max), percentiles come from a fixed-size reservoir, so a
    long-lived server's accounting is O(1) in flush count.  ``summary()``
    keeps the historical keys (requests / waves / slots / padded_slots /
    total_s / qps) and adds the latency-decomposition and backpressure
    fields; ``snapshot()`` is the full structured tree.  The keys are the
    JAX package's: ``padded_slots`` counts a mesh's batch pads and
    ``fallbacks_total`` the waves an open mesh breaker served on one device.
    """

    def __init__(self, metrics: ServerMetrics | None = None):
        self.metrics = metrics if metrics is not None else ServerMetrics()

    @property
    def requests(self) -> int:
        return self.metrics.counters["requests"]

    @property
    def waves(self) -> int:
        return self.metrics.counters["waves"]

    @property
    def slots(self) -> int:  # total engine slots dispatched (incl. batch pads)
        return self.metrics.counters["slots"]

    @property
    def padded_slots(self) -> int:  # batch-pad slots (a mesh's batch axis)
        return self.metrics.counters["padded_slots"]

    @property
    def rejections(self) -> int:  # submits refused by backpressure
        return self.metrics.counters["rejections"]

    @property
    def total_seconds(self) -> float:
        return float(self.metrics.wave_s.total)

    @property
    def qps(self) -> float:
        t = self.total_seconds
        return self.requests / t if t > 0 else 0.0

    def summary(self) -> dict:
        m = self.metrics
        return {
            "requests": self.requests,
            "waves": self.waves,
            "slots": self.slots,
            "padded_slots": self.padded_slots,
            "total_s": round(self.total_seconds, 4),
            "qps": round(self.qps, 1),
            "wave_p50_s": round(m.wave_s.percentile(0.50), 4) if self.waves else 0.0,
            "wave_p99_s": round(m.wave_s.percentile(0.99), 4) if self.waves else 0.0,
            "queue_p50_s": round(m.queue_s.percentile(0.50), 4)
            if m.queue_s.count
            else 0.0,
            "queue_p99_s": round(m.queue_s.percentile(0.99), 4)
            if m.queue_s.count
            else 0.0,
            "rejections": self.rejections,
            "deadline_misses": m.counters["deadline_misses"],
            "retries_total": m.counters["retries_total"],
            "fallbacks_total": m.counters["fallbacks_total"],
            "quarantined_total": m.counters["quarantined_total"],
            "breaker_state": dict(sorted(m.breaker_states.items())),
        }

    def snapshot(self) -> dict:
        """The full structured metric tree (see launch/metrics.py schema)."""
        return self.metrics.snapshot()


class SelectionServer:
    """Per-group coalescing selection server over :class:`BatchedEngine`.

    Args:
      mesh: a mesh from ``distributed.make_mesh`` to serve on (None: one
        device).  Every rank builds the server with it; rank 0 is the front
        door and every other rank a follower that runs :meth:`follow`.
        ``batch_axis`` / ``data_axis`` name its axes (validated here).
      max_wave: cap on real requests per wave (bounds per-wave latency).
      max_queue: admission-control cap on TOTAL pending requests across all
        group queues; ``submit`` raises :class:`ServerOverloaded` beyond it.
        None (default) disables backpressure.
      retry_policy: server-wide default :class:`~repro_torch.launch.
        resilience.RetryPolicy`.  When it is set — or any pending spec
        carries its own ``retry`` — ``flush()`` switches to the resilient
        path: transient wave failures are retried with backoff, the poison
        request is isolated into a singleton wave so it cannot re-poison its
        group, and exhausted requests resolve to typed
        :class:`~repro_torch.launch.resilience.RequestFailed` entries
        (``take_failures()``) instead of aborting the flush.  A request's
        ``spec.retry`` always wins over the server default.  With neither
        set, ``flush()`` keeps the single-attempt :class:`FlushError`
        contract exactly.
      breakers: a :class:`~repro_torch.launch.resilience.BreakerBoard` (one
        is created when omitted).  Kernel faults of a wave on a CUDA-kernel
        backend (an injected ``"kernel"`` fault, a kernel that fails to
        build or launch) charge ``(family, "kernel")``; while it is open,
        dispatch refuses that family's kernel waves with
        :class:`~repro_torch.launch.resilience.BreakerOpen` (typed
        failures, never a reroute to the torch sweeps).  On a mesh,
        ``(family, "mesh")`` is charged by a dispatch fault there and by any
        error that refuses a wave on the mesh before it runs; while it is
        open the family's waves run on rank 0's card alone, on the same
        kernels (``degraded="single-device"``, ``fallbacks_total``).
      control_timeout: the mesh control group's timeout (default: the
        mesh's); rank 0 sends an idle header every quarter of it.
      on_mesh_wave: called on this rank with each mesh wave's whole-batch
        results, in wave order (for checks that compare the ranks).

    The dispatch path is synchronous; ``submit`` only enqueues (into the
    request's group queue — the coalescer's wave identity promoted to queue
    identity).  The async front-end that flushes each group on its own
    depth / timer / deadline triggers and completes futures is
    :class:`repro_torch.launch.async_serve.AsyncSelectionServer`; it drives
    this server through ``drain`` / ``dispatch_waves`` so its lock never
    covers an engine dispatch.  Kernels launch on the calling thread's
    current stream, the legacy default stream unless the caller set
    another, so tensors a submitter built are ordered before the wave that
    reads them.
    """

    def __init__(
        self,
        mesh=None,
        batch_axis: str = "batch",
        data_axis: str = "data",
        max_wave: int = 64,
        max_queue: int | None = None,
        retry_policy: RetryPolicy | None = None,
        breakers: BreakerBoard | None = None,
        control_timeout=None,
        on_mesh_wave=None,
    ):
        # on a mesh: the control plane (a collective: every rank builds it)
        self._plane = (None if mesh is None
                       else MeshPlane(mesh, batch_axis, data_axis, timeout=control_timeout,
                                      on_wave=on_mesh_wave))
        self.mesh = mesh
        self.b_multiple = 1 if mesh is None else self._plane.b_multiple
        self.n_multiple = 1 if mesh is None else self._plane.n_multiple
        self.batch_axis = batch_axis
        self.data_axis = data_axis
        self.max_wave = max_wave
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 or None, got {max_queue}")
        self.max_queue = max_queue
        if retry_policy is not None and not isinstance(retry_policy, RetryPolicy):
            raise TypeError(
                f"retry_policy must be a RetryPolicy or None, "
                f"got {type(retry_policy).__name__!r}"
            )
        self.retry_policy = retry_policy
        self.breakers = breakers if breakers is not None else BreakerBoard()
        # group_key -> FIFO of SelectionRequests (insertion-ordered dict, so
        # flush order follows each group's first arrival)
        self._queues: dict[tuple, list[SelectionRequest]] = {}
        self._undelivered: dict = {}  # flushed but not yet returned to a caller
        self._failures: dict = {}  # rid -> RequestFailed, not yet taken
        self._attempts: dict = {}  # rid -> [attempt dicts] across retries
        self._next_rid = 0
        self._dispatch_seq = 0  # 0-based dispatch ordinal (fault addressing)
        self.metrics = ServerMetrics()
        self.stats = ServerStats(self.metrics)
        self.breakers.bind(self.metrics.set_breaker)

    # -- the mesh's ranks -----------------------------------------------------

    @property
    def is_follower(self) -> bool:
        """True on a mesh rank other than 0: it runs :meth:`follow`."""
        return self._plane is not None and not self._plane.leader

    def _front_door(self, what: str, alive: bool = True) -> None:
        """Raise unless this rank may take ``what``: rank 0 of a mesh server
        (whose plane, with ``alive``, has not failed), or any server off a
        mesh."""
        if self._plane is None:
            return
        if not self._plane.leader:
            raise FollowerError(
                f"SelectionServer.{what} runs on rank 0, the mesh server's front door; "
                f"rank {self._plane.rank} follows it: call server.follow()"
            )
        if alive:
            self._plane.check_alive()

    def follow(self):
        """Run the mesh waves rank 0 sends until its :meth:`close` (a
        follower's whole job); returns the payload of rank 0's stop.
        Raises :class:`~repro_torch.launch.mesh_plane.MeshFailed` when the
        mesh fails, and ``FollowerError`` on rank 0."""
        if self._plane is None:
            raise FollowerError("follow() is for a mesh server's ranks other than 0")
        return self._plane.follow()

    def close(self, payload=None) -> None:
        """Rank 0 of a mesh server: stop the followers (their ``follow()``
        returns ``payload``).  Idempotent; nothing to do off a mesh or on a
        follower."""
        if self._plane is not None:
            self._plane.close(payload)

    @property
    def mesh_stats(self) -> dict:
        """The control plane's counters on this rank: mesh waves run, the
        member-tensor bytes and broadcast seconds of rank 0's plans, and its
        latest plans (bytes, broadcast and wave seconds each)."""
        p = self._plane
        if p is None:
            return {}
        return {"rank": p.rank, "waves": p.waves, "plan_bytes": p.plan_bytes,
                "broadcast_s": p.broadcast_s, "plans": list(p.plans)}

    # -- request ingest ------------------------------------------------------

    @property
    def pending_count(self) -> int:
        """Total pending requests across all group queues."""
        return sum(len(q) for q in self._queues.values())

    def submit_spec(self, spec: SelectionSpec, rid=None):
        """Enqueue one validated :class:`SelectionSpec` into its group's
        queue; returns its request id.

        Everything that could poison a flush is rejected HERE, at submit
        time, so a bad request can never abort the flush that would have
        answered everyone else's:

        - an unsupported function family (no registered padder) raises
          ``NotImplementedError`` naming ``register_padder``;
        - an optimizer without batched execution hooks (e.g.
          StochasticGreedy) raises ``ValueError`` naming the batched-capable
          set;
        - a full server (``max_queue`` pending) raises
          :class:`ServerOverloaded` — admission control, counted under
          ``rejections``.

        Unknown optimizer names, misspelled hyperparameters, and family
        stop-rule defaults were already handled when the spec was built —
        requests are specs, so serving adds no second validation dialect.
        """
        if not isinstance(spec, SelectionSpec):
            raise TypeError(
                f"submit_spec() takes a SelectionSpec, got {type(spec).__name__!r}"
            )
        self._front_door("submit")
        coalesce.resolve_padder(type(spec.fn))  # raises NotImplementedError if unsupported
        defn = resolve_optimizer(spec.optimizer.name)
        if not defn.batched_capable:
            raise ValueError(
                f"optimizer {spec.optimizer.name!r} has no batched execution "
                f"hooks, so it cannot ride served waves; batched-capable "
                f"optimizers: {wave_capable_names()}"
            )
        if self.max_queue is not None and self.pending_count >= self.max_queue:
            self.metrics.inc("rejections")
            raise ServerOverloaded(
                f"pending queue is full ({self.pending_count}/{self.max_queue} "
                f"requests); flush, raise max_queue, or retry after a drain"
            )
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        req = SelectionRequest(rid=rid, spec=spec)
        key = group_key(req, n_multiple=self.n_multiple)
        queue = self._queues.setdefault(key, [])
        queue.append(req)
        self.metrics.observe_enqueue(group_label(req, n_multiple=self.n_multiple), len(queue))
        return rid

    def submit(
        self,
        request,
        budget: int | None = None,
        optimizer: str | None = None,
        rid=None,
        **kwargs,
    ):
        """Enqueue one selection request; returns its request id.

        The request is a :class:`SelectionSpec` (the typed path —
        equivalent to :meth:`submit_spec`).  The legacy
        ``submit(fn, budget, optimizer=..., stopIfZeroGain=..., screen_k=...)``
        form is deprecated: it builds the spec for you (family stop-rule
        defaults — e.g. Disparity*'s ``stopIfZeroGain=False`` — now resolve
        inside :class:`SelectionSpec`, so sequential and served execution
        agree) and emits a ``DeprecationWarning``.
        """
        if isinstance(request, SelectionSpec):
            if budget is not None or optimizer is not None or kwargs:
                raise TypeError(
                    "submit(spec) takes no extra options — budget, optimizer "
                    "and stop rules already live on the SelectionSpec"
                )
            return self.submit_spec(request, rid=rid)
        from repro_torch.core.optimizers.api import _warn_shim

        _warn_shim(
            "SelectionServer.submit(fn, budget, ...)",
            "SelectionServer.submit(SelectionSpec(fn, budget, ...))",
        )
        spec = SelectionSpec(
            request,
            budget,
            "NaiveGreedy" if optimizer is None else optimizer,
            stopIfZeroGain=kwargs.pop("stopIfZeroGain", None),
            stopIfNegativeGain=kwargs.pop("stopIfNegativeGain", None),
            **kwargs,
        )
        return self.submit_spec(spec, rid=rid)

    def open_session(self, spec: SelectionSpec, *, sid=None, journal=None):
        """Open a long-lived :class:`~repro_torch.launch.sessions.SelectionSession`
        around ``spec``: feed ground-set deltas with ``extend(features=...)``
        / ``extend(indices=...)`` and get the refreshed selection after each.
        Deltas ride the normal per-group queues (same coalescing, same
        backpressure), so every update is bit-identical to a direct
        ``solve()`` over the stream so far.  Pass a
        :class:`~repro_torch.launch.sessions.SessionJournal` (and optionally
        a stable ``sid``) to journal committed deltas for crash recovery via
        :func:`~repro_torch.launch.sessions.restore_sessions`."""
        from repro_torch.launch.sessions import SelectionSession

        self._front_door("open_session")
        return SelectionSession(self, spec, sid=sid, journal=journal)

    def cancel(self, rid) -> bool:
        """Remove one pending request (or one undelivered response) by id.
        Returns True if something was removed.  The escape hatch after a
        :class:`FlushError` named a poisoned request as failed: cancel it
        and re-flush the survivors."""
        for key, queue in list(self._queues.items()):
            for i, req in enumerate(queue):
                if req.rid == rid:
                    del queue[i]
                    if not queue:
                        del self._queues[key]
                    return True
        return self._undelivered.pop(rid, None) is not None

    def group_states(self) -> list[tuple]:
        """Scheduling view of the pending queues: one
        ``(group_key, depth, oldest_enqueue_t, earliest_deadline_t)`` tuple
        per non-empty group (``earliest_deadline_t`` is None when no member
        carries a deadline).  The async front end's flush triggers read
        this; it is also handy for dashboards."""
        out = []
        for key, queue in self._queues.items():
            deadlines = [t for t in (r.deadline_t for r in queue) if t is not None]
            out.append(
                (
                    key,
                    len(queue),
                    queue[0].enqueue_t,
                    min(deadlines) if deadlines else None,
                )
            )
        return out

    # -- dispatch ------------------------------------------------------------

    def _waves(self, requests, max_wave: int) -> list[Wave]:
        return waves_for_group(requests, max_wave=max_wave, n_multiple=self.n_multiple,
                               b_multiple=self.b_multiple)

    def _dispatch(self, wave: Wave) -> dict:
        fam = type(wave.requests[0].spec.fn).__name__
        widx = self._dispatch_seq
        self._dispatch_seq += 1
        # bookkeeping probe: the wave's backend, for the breakers and fault
        # addressing — suspended so it never consumes fault budget
        with faults.suspended():
            name = backend_name(wave.fns[0])
        key = None if name == "torch" else (fam, "kernel")
        if key is not None and not self.breakers.allow(key):
            raise BreakerOpen(key)
        on_mesh = self._plane is not None
        degraded = None
        if on_mesh and not self.breakers.allow((fam, "mesh")):
            # open mesh breaker: rank 0's card alone, the same kernels
            on_mesh, degraded = False, "single-device"
            self.metrics.inc("fallbacks_total")
        t0 = coalesce.clock()
        try:
            faults.check(
                "dispatch",
                family=fam,
                backend=name,
                wave_index=widx,
                mesh=on_mesh,
                rids=tuple(r.rid for r in wave.requests),
                label=wave.label,
            )
            # host-side backend resolution is the "kernel" fault boundary
            # (resolve_backend), crossed once per dispatch as in the JAX
            # package, whose engine resolves backends once, at trace time
            backend_name(wave.fns[0])
            if on_mesh:
                self._plane.check(wave)  # refusals, before any plan goes out
                results = self._plane.run_wave(wave, widx)
            else:
                with faults.suspended():
                    engine = BatchedEngine(wave.fns, valid=wave.valid)
                    results = engine.run(
                        wave.budgets,
                        wave.optimizer,
                        stop_if_zero=wave.stop_if_zero,
                        stop_if_negative=wave.stop_if_negative,
                        max_budget=wave.max_budget,
                    )
        except MeshFailed:
            raise  # fatal: the plane refuses every later call
        except Exception as e:
            # only kernel faults charge the kernel breaker: not bad input,
            # not a dispatch fault, not running out of memory; on the mesh
            # every other failure (all of them before the plan) charges the
            # mesh breaker
            if key is not None and (
                isinstance(e, KernelError) or getattr(e, "site", None) == "kernel"
            ):
                self.breakers.record_failure(key)
            elif on_mesh:
                self.breakers.record_failure((fam, "mesh"))
            raise
        if key is not None:
            self.breakers.record_success(key)
        if on_mesh:
            self.breakers.record_success((fam, "mesh"))
        t1 = coalesce.clock()
        wave_s = t1 - t0
        label = wave.label
        self.metrics.observe_wave(
            label,
            wave_s,
            requests=len(wave.requests),
            slots=wave.batch_size,
            padded_slots=wave.n_padded_slots,
        )
        by_rid = wave.demux(results)
        out = {}
        for req in wave.requests:
            queue_s = max(0.0, t0 - req.enqueue_t)
            missed = req.deadline_t is not None and t1 > req.deadline_t
            self.metrics.observe_served(label, queue_s, deadline_missed=missed)
            out[req.rid] = SelectionResponse(
                rid=req.rid,
                selection=by_rid[req.rid].as_list(),
                result=by_rid[req.rid],
                wave_size=len(wave.requests),
                n_bucket=wave.n_bucket,
                backend=name,
                latency_s=queue_s + wave_s,
                queue_s=queue_s,
                wave_s=wave_s,
                deadline_missed=missed,
                degraded=degraded,
            )
        return out

    def drain(
        self, keys: Optional[Sequence[tuple]] = None, *, take_undelivered: bool = True
    ) -> tuple[list[Wave], dict]:
        """Atomically remove pending requests and build their waves.

        Args:
          keys: group keys to drain (default: every non-empty group).  This
            is the continuous-batching hook — a front end drains just the
            groups whose own trigger fired.
          take_undelivered: also take (and clear) the held responses from
            earlier partial flushes; ``flush()`` wants them, the async front
            end leaves them for the sync caller.

        Returns ``(waves, undelivered)``.  ALL waves are built before any
        queue entry is removed, so a wave-build error leaves the server
        state fully intact (nothing half-drained).
        """
        self._front_door("drain", alive=False)
        if keys is None:
            keys = list(self._queues)
        waves: list[Wave] = []
        for key in keys:
            requests = self._queues.get(key)
            if not requests:
                continue
            waves.extend(self._waves(requests, self.max_wave))
        for key in keys:
            self._queues.pop(key, None)
        undelivered: dict = {}
        if take_undelivered:
            undelivered, self._undelivered = self._undelivered, {}
        return waves, undelivered

    def dispatch_waves(self, waves: Sequence[Wave]) -> dict:
        """Dispatch already-built waves in order; returns {rid: response}.

        Pure compute — touches no queues, so it is safe to call OUTSIDE any
        lock guarding them.  On an engine error it raises
        :class:`FlushError` carrying the exact work partition (completed
        responses / failed wave / undispatched waves); the caller decides
        how to re-hold and re-enqueue.  A mesh failure
        (:class:`~repro_torch.launch.mesh_plane.MeshFailed`) is fatal and
        raises as it is.
        """
        self._front_door("dispatch_waves")
        responses: dict = {}
        for i, wave in enumerate(waves):
            try:
                responses.update(self._dispatch(wave))
            except MeshFailed:
                raise
            except Exception as e:
                self.metrics.inc("flush_errors")
                undispatched = [r for w in waves[i + 1 :] for r in w.requests]
                failed = list(wave.requests)
                raise FlushError(
                    f"wave {i + 1}/{len(waves)} ({wave.label}, "
                    f"{len(failed)} requests: {[r.rid for r in failed]}) "
                    f"failed: {e}; {len(responses)} completed responses held, "
                    f"{len(undispatched)} undispatched requests preserved",
                    completed=responses,
                    failed_requests=failed,
                    undispatched_requests=undispatched,
                ) from e
        return responses

    def requeue(self, requests: Sequence[SelectionRequest]) -> None:
        """Put drained-but-unserved requests back at the FRONT of their
        group queues, original arrival stamps intact (so queue-time
        accounting spans the failure, truthfully)."""
        for req in reversed(list(requests)):
            key = group_key(req, n_multiple=self.n_multiple)
            self._queues.setdefault(key, []).insert(0, req)
        if requests:
            self.metrics.inc("requeued", len(requests))

    # -- resilience ----------------------------------------------------------

    def _resilience_active(self) -> bool:
        """True when flushes should run the retry/quarantine path: a
        server-wide ``retry_policy``, or any pending spec carrying its own
        ``retry``.  With neither, flush keeps the legacy single-attempt
        :class:`FlushError` contract."""
        if self.retry_policy is not None:
            return True
        return any(
            req.spec.retry is not None
            for queue in self._queues.values()
            for req in queue
        )

    def _policy_for(self, req: SelectionRequest) -> RetryPolicy:
        """The request's effective policy: its spec's, else the server's,
        else single-attempt (fail typed on first error, no retry)."""
        if req.spec.retry is not None:
            return req.spec.retry
        if self.retry_policy is not None:
            return self.retry_policy
        return SINGLE_ATTEMPT

    def _note_attempt(self, req: SelectionRequest, error) -> RequestFailed | None:
        """Charge one failed attempt against ``req``'s budget.  Returns the
        terminal :class:`RequestFailed` when the budget is exhausted —
        ``max_attempts`` (``"quarantined"``) or wall-clock ``timeout_s``
        (``"timeout"``) — or the wave met an open breaker
        (``"breaker_open"``: retrying into it is refused again), else None
        (the request may retry)."""
        now = coalesce.clock()
        hist = self._attempts.setdefault(req.rid, [])
        hist.append(
            {
                "attempt": len(hist) + 1,
                "error": f"{type(error).__name__}: {error}",
                "elapsed_s": round(max(0.0, now - req.enqueue_t), 6),
            }
        )
        pol = self._policy_for(req)
        if isinstance(error, BreakerOpen):
            reason = "breaker_open"
        elif pol.timeout_s is not None and now - req.enqueue_t >= pol.timeout_s:
            reason = "timeout"
        elif len(hist) >= pol.max_attempts:
            reason = "quarantined"
            self.metrics.inc("quarantined_total")
        else:
            return None
        self._attempts.pop(req.rid, None)
        return RequestFailed(req.rid, reason, hist, cause=error)

    def _isolate(self, req: SelectionRequest, failures: dict) -> Wave | None:
        """Rebuild ``req`` as a singleton wave for a retry.  Build (padder)
        errors are charged against its attempt budget like any other; on
        exhaustion the terminal failure lands in ``failures`` and None is
        returned."""
        while True:
            try:
                return self._waves([req], 1)[0]
            except Exception as e:
                self.metrics.inc("flush_errors")
                term = self._note_attempt(req, e)
                if term is not None:
                    failures[req.rid] = term
                    return None
                self.metrics.inc("retries_total")
                wait = self._policy_for(req).backoff(
                    len(self._attempts[req.rid]), seed=req.rid
                )
                if wait > 0:
                    time.sleep(wait)

    def dispatch_resilient(self, waves: Sequence[Wave]) -> tuple[dict, dict]:
        """Dispatch waves with per-request retry, poison isolation, and
        typed quarantine; returns ``(responses, failures)`` — every drained
        rid resolves into exactly one of the two dicts, and no exception
        escapes for a wave failure.

        On a wave failure each rider is charged one attempt: exhausted
        requests fail typed (:class:`RequestFailed` in ``failures``), the
        rest retry — a multi-request wave is rebuilt as singleton waves
        first, so the one poison request cannot re-poison its co-travellers
        (they succeed alone on the next attempt).  Backoff between attempts
        follows each request's policy with jitter seeded by its rid, so
        reruns back off identically.  Like :meth:`dispatch_waves` this
        touches no queues and is safe outside any queue lock.  A mesh
        failure is fatal, not retried: it raises as it is.
        """
        self._front_door("dispatch_resilient")
        responses: dict = {}
        failures: dict = {}
        pending: list[Wave] = list(waves)
        while pending:
            wave = pending.pop(0)
            try:
                out = self._dispatch(wave)
            except MeshFailed:
                raise
            except Exception as e:
                self.metrics.inc("flush_errors")
                retryable = []
                for req in wave.requests:
                    term = self._note_attempt(req, e)
                    if term is not None:
                        failures[req.rid] = term
                    else:
                        retryable.append(req)
                if not retryable:
                    continue
                self.metrics.inc("retries_total", len(retryable))
                if len(wave.requests) > 1:
                    # poison isolation: each survivor retries ALONE
                    rebuilt = []
                    for req in retryable:
                        w = self._isolate(req, failures)
                        if w is not None:
                            rebuilt.append(w)
                    pending[:0] = rebuilt
                else:
                    pending.insert(0, wave)  # already a singleton
                live = [r for r in retryable if r.rid in self._attempts]
                if live:
                    wait = max(
                        self._policy_for(r).backoff(
                            len(self._attempts[r.rid]), seed=r.rid
                        )
                        for r in live
                    )
                    if wait > 0:
                        time.sleep(wait)
                continue
            for req in wave.requests:
                prior = self._attempts.pop(req.rid, None)
                if prior:
                    out[req.rid].attempts = len(prior) + 1
            responses.update(out)
        return responses, failures

    def drain_resilient(
        self, keys: Optional[Sequence[tuple]] = None, *, take_undelivered: bool = True
    ) -> tuple[list[Wave], dict, dict, float]:
        """Like :meth:`drain`, but a wave-build (padder) error costs ONE
        group instead of aborting the whole drain, and requests whose
        wall-clock ``timeout_s`` already lapsed are reaped before any build.

        Returns ``(waves, undelivered, failures, retry_wait)``:
        ``failures`` maps reaped/exhausted rids to :class:`RequestFailed`;
        a group whose build failed keeps its retryable requests QUEUED and
        reports the backoff to wait before re-draining via ``retry_wait``
        (this method never sleeps — the async front end calls it under its
        lock).
        """
        self._front_door("drain_resilient", alive=False)
        if keys is None:
            keys = list(self._queues)
        waves: list[Wave] = []
        failures: dict = {}
        retry_wait = 0.0
        for key in list(keys):
            requests = self._queues.get(key)
            if not requests:
                self._queues.pop(key, None)
                continue
            now = coalesce.clock()
            live = []
            for req in requests:
                pol = self._policy_for(req)
                if pol.timeout_s is not None and now - req.enqueue_t >= pol.timeout_s:
                    hist = self._attempts.pop(req.rid, [])
                    failures[req.rid] = RequestFailed(req.rid, "timeout", hist)
                else:
                    live.append(req)
            if not live:
                self._queues.pop(key, None)
                continue
            try:
                group_waves = self._waves(live, self.max_wave)
            except Exception as e:
                self.metrics.inc("flush_errors")
                keep = []
                for req in live:
                    term = self._note_attempt(req, e)
                    if term is not None:
                        failures[req.rid] = term
                    else:
                        keep.append(req)
                if keep:
                    self.metrics.inc("retries_total", len(keep))
                    self._queues[key] = keep
                    retry_wait = max(
                        retry_wait,
                        max(
                            self._policy_for(r).backoff(
                                len(self._attempts[r.rid]), seed=r.rid
                            )
                            for r in keep
                        ),
                    )
                else:
                    self._queues.pop(key, None)
                continue
            waves.extend(group_waves)
            self._queues.pop(key, None)
        undelivered: dict = {}
        if take_undelivered:
            undelivered, self._undelivered = self._undelivered, {}
        return waves, undelivered, failures, retry_wait

    def take_failures(self) -> dict:
        """Hand over (and clear) the typed failures from resilient flushes:
        ``{rid: RequestFailed}``.  Each failure is delivered exactly once —
        callers own what they take."""
        out, self._failures = self._failures, {}
        return out

    def hold_failures(self, failures: dict) -> None:
        """Re-hold typed failures for a later :meth:`take_failures` — the
        async front end stashes failures for rids owned by the sync flush
        path here, mirroring :meth:`hold_undelivered`."""
        self._failures.update(failures)

    def _flush_resilient(self) -> dict:
        """The resilient flush body: rounds of drain + dispatch until every
        queue is empty.  Groups whose build failed retryably stay queued
        between rounds (backoff honored here, outside any lock); every
        drained rid ends as exactly one response (returned) or one
        :class:`RequestFailed` (held for :meth:`take_failures`)."""
        responses: dict = {}
        failures: dict = {}
        first = True
        while True:
            waves, undelivered, drain_failures, retry_wait = self.drain_resilient(
                take_undelivered=first
            )
            first = False
            responses.update(undelivered)
            failures.update(drain_failures)
            if waves:
                out, dispatch_failures = self.dispatch_resilient(waves)
                responses.update(out)
                failures.update(dispatch_failures)
            if not any(self._queues.values()):
                break
            if retry_wait > 0:
                time.sleep(retry_wait)
        if failures:
            self.hold_failures(failures)
        return responses

    def flush(self) -> dict:
        """Drain every group + dispatch; returns {rid: response}, including
        any responses computed by an earlier ``select`` call on behalf of
        requests it didn't own (nothing is ever dropped).

        On a mid-flush engine error, raises :class:`FlushError` AFTER
        restoring the server to a no-loss state: completed responses (this
        flush's and previously-held ones) are re-held for the next call,
        and every unserved request — the failed wave's and the
        never-dispatched ones — is re-enqueued at the front of its queue.
        ``e.failed_rids`` names the poisoned wave; ``cancel`` those before
        retrying if the requests themselves are at fault.

        When a :class:`~repro_torch.launch.resilience.RetryPolicy` is in play
        (server-wide or on any pending spec) this switches to the resilient
        path instead: transient failures retry with backoff, the poison
        request is isolated, and exhausted requests resolve to typed
        failures via :meth:`take_failures` — :class:`FlushError` is never
        raised.
        """
        self._front_door("flush")
        if self._resilience_active():
            return self._flush_resilient()
        waves, responses = self.drain()
        try:
            responses.update(self.dispatch_waves(waves))
        except FlushError as e:
            responses.update(e.completed)
            self.hold_undelivered(responses)
            # front-of-queue order: failed wave ahead of the undispatched
            # tail, matching original arrival order
            self.requeue(e.undispatched_requests)
            self.requeue(e.failed_requests)
            raise
        return responses

    def hold_undelivered(self, responses: dict) -> None:
        """Re-hold already-computed responses for delivery by a later
        ``flush()``.  Used by callers that drain ``flush()`` on behalf of a
        subset of requests (``select``, the async front end) so responses to
        everyone else's requests are never dropped."""
        self._undelivered.update(responses)

    def select(self, requests: Sequence) -> list[SelectionResponse]:
        """Convenience: submit specs — or (fn, budget) pairs, which become
        ``SelectionSpec(fn, budget)`` with family defaults — flush, and
        return responses in request order.  Responses to requests enqueued
        earlier via ``submit`` ride the same flush and are held for the next
        ``flush`` call.  Where one of these requests failed typed (the
        resilient flush), its :class:`RequestFailed` is raised; every
        response of the flush is then held for the next ``flush``, and the
        other requests' failures for ``take_failures``."""
        specs = [
            r if isinstance(r, SelectionSpec) else SelectionSpec(r[0], r[1])
            for r in requests
        ]
        rids = [self.submit_spec(s) for s in specs]
        out = self.flush()
        failures = self.take_failures()
        mine_failed = [failures.pop(r) for r in rids if r in failures]
        self.hold_failures(failures)
        if mine_failed:
            self.hold_undelivered(out)
            raise mine_failed[0]
        mine = [out.pop(r) for r in rids]
        self.hold_undelivered(out)
        return mine


# ---------------------------------------------------------------------------
# CLI: serve a random mixed workload and report throughput.
# ---------------------------------------------------------------------------

# dispersion families: the empty-set gain is 0.  SelectionSpec's per-family
# default table already sets stopIfZeroGain=False for them; the CLI
# additionally disables stopIfNegativeGain so long-budget requests keep
# selecting past the point where adding an element shrinks the dispersion
# objective
DISPERSION_FAMILIES = frozenset({"dsum", "dmin"})


def _random_function(kind: str, n: int, rng, device):
    """One random instance of a served family, built from ``rng`` (numpy)
    on ``device``: the JAX package's CLI workload (shared by tests)."""
    from repro_torch.core import (
        FLQMI,
        GCMI,
        DisparityMin,
        DisparitySum,
        FacilityLocation,
        FeatureBased,
        GraphCut,
        LogDet,
        ProbabilisticSetCover,
        SetCover,
        create_kernel,
    )

    def kernel():
        x = rng.normal(size=(n, 8)).astype(np.float32)
        return create_kernel(x, metric="euclidean", device=device)

    if kind == "fl":
        return FacilityLocation.from_kernel(kernel())
    if kind == "gc":
        return GraphCut.from_kernel(kernel(), lam=0.3)
    if kind == "fb":
        feats = rng.uniform(0, 1, size=(n, 12)).astype(np.float32)
        return FeatureBased.from_features(feats, concave="sqrt", device=device)
    if kind == "sc":
        cover = rng.integers(0, 2, size=(n, 16)).astype(np.float32)
        return SetCover.from_cover(cover, device=device)
    if kind == "psc":
        probs = rng.uniform(0, 0.9, size=(n, 16)).astype(np.float32)
        return ProbabilisticSetCover.from_probs(probs, device=device)
    if kind == "dsum":
        return DisparitySum.from_distance(1.0 - kernel())
    if kind == "dmin":
        return DisparityMin.from_distance(1.0 - kernel())
    if kind == "flqmi":
        x = rng.normal(size=(n, 8)).astype(np.float32)
        q = rng.normal(size=(6, 8)).astype(np.float32)
        return FLQMI.build(create_kernel(q, x, metric="euclidean", device=device))
    if kind == "gcmi":
        x = rng.normal(size=(n, 8)).astype(np.float32)
        q = rng.normal(size=(5, 8)).astype(np.float32)
        return GCMI.build(create_kernel(x, q, metric="euclidean", device=device), lam=0.4)
    if kind == "logdet":
        import torch

        S = kernel() + 0.5 * torch.eye(n, device=device)
        return LogDet.from_kernel(S, max_select=16)
    raise KeyError(kind)


def _random_requests(
    n_requests: int, seed: int = 0, families: Sequence[str] = ("fl", "gc", "fb"),
    device="cuda",
):
    """A mixed workload with varying n, cycling through ``families`` (any of
    fl / gc / fb / sc / psc / dsum / dmin / flqmi / gcmi / logdet): the same
    draws as the JAX package's CLI for the same seed."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        n = int(rng.choice([24, 32, 48, 64]))
        budget = int(rng.integers(3, 9))
        fn = _random_function(families[i % len(families)], n, rng, device)
        reqs.append((fn, budget))
    return reqs


def _join_mesh(a):
    """``--mesh BxD``: join the world (``--dist-init``; torchrun's
    environment by default) and build the ("batch", "data") mesh on this
    rank's device.  Returns (mesh, device)."""
    import os

    import torch.distributed as dist

    from repro_torch.common import resolve_device
    from repro_torch.core.optimizers.distributed import _info, make_mesh

    b, d = (int(v) for v in a.mesh.lower().split("x"))
    on_cpu = resolve_device(a.device).type == "cpu"
    backend = "gloo" if on_cpu else "nccl"
    rank = a.rank if a.rank is not None else int(os.environ.get("RANK", -1))
    world = a.world_size if a.world_size is not None else int(os.environ.get("WORLD_SIZE", -1))
    dist.init_process_group(backend, init_method=a.dist_init, rank=rank, world_size=world)
    mesh = make_mesh((b, d), ("batch", "data"), device="cpu" if on_cpu else None)
    return mesh, _info(mesh).device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument(
        "--mesh",
        default=None,
        help="BATCHxDATA mesh to serve on, e.g. 2x2: every rank runs this "
        "command (torchrun --nproc-per-node B*D); rank 0 makes the requests "
        "and reports, the others follow (default: one device)",
    )
    ap.add_argument("--dist-init", default="env://",
                    help="--mesh: init_method of the world (e.g. file:///tmp/store)")
    ap.add_argument("--rank", type=int, default=None, help="--mesh: this rank (default $RANK)")
    ap.add_argument("--world-size", type=int, default=None,
                    help="--mesh: the world's size (default $WORLD_SIZE)")
    ap.add_argument("--max-wave", type=int, default=64)
    ap.add_argument(
        "--max-queue",
        type=int,
        default=None,
        help="backpressure cap on pending requests (default: unbounded)",
    )
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--families",
        default="fl,gc,fb",
        help="comma-separated families to mix into the workload "
        "(fl,gc,fb,sc,psc,dsum,dmin,flqmi,gcmi,logdet)",
    )
    ap.add_argument(
        "--metrics",
        action="store_true",
        help="print the full structured metrics snapshot (JSON) at the end",
    )
    ap.add_argument("--device", default="cuda", help="where the requests' tensors live")
    a = ap.parse_args(argv)

    from repro_torch.common import resolve_device

    if a.mesh is None:
        _serve(a, SelectionServer(max_wave=a.max_wave, max_queue=a.max_queue),
               resolve_device(a.device))
        return
    import torch.distributed as dist

    mesh, device = _join_mesh(a)
    try:
        server = SelectionServer(mesh=mesh, max_wave=a.max_wave, max_queue=a.max_queue)
        if server.is_follower:
            server.follow()
        else:
            try:
                _serve(a, server, device)
            finally:
                server.close()
    finally:
        dist.destroy_process_group()


def _serve(a, server: SelectionServer, device) -> None:
    """Rank 0's (or the single device's) rounds of the CLI workload."""
    families = tuple(a.families.split(","))
    requests = _random_requests(a.requests, seed=a.seed, families=families, device=device)
    # same family indexing as _random_requests: dispersion requests ride with
    # stopping disabled, otherwise their selections are silently empty
    kinds = [families[i % len(families)] for i in range(len(requests))]
    # GraphCut / Disparity* run on a mesh in their memoized form only
    # (their stateless kernels sum in another order than the shard rules)
    memo = ("gc", "dsum", "dmin") if server.mesh is not None else ()
    requests = [(dataclasses.replace(fn, use_kernel=False) if kind in memo else fn, budget)
                for (fn, budget), kind in zip(requests, kinds)]

    for rnd in range(a.rounds):
        t0 = time.perf_counter()
        rids = [
            server.submit(
                SelectionSpec(fn, budget, stopIfNegativeGain=kind not in DISPERSION_FAMILIES)
            )
            for (fn, budget), kind in zip(requests, kinds)
        ]
        out = server.flush()
        responses = [out[r] for r in rids]
        dt = time.perf_counter() - t0
        assert len(responses) == len(requests)
        assert all(r.selection for r in responses), "empty selection served"
        label = "warmup (first kernel builds)" if rnd == 0 else "steady"
        print(
            f"round {rnd}: {len(requests)} requests in {dt:.3f}s "
            f"({len(requests) / dt:.1f} q/s)  [{label}]"
        )

    s = server.stats.summary()
    print(f"\nserver stats: {s}")
    if server.mesh is not None:
        print(f"mesh: { {k: v for k, v in server.mesh_stats.items() if k != 'plans'} }")
    r0 = responses[0]
    print(
        f"sample response: rid={r0.rid} wave={r0.wave_size} "
        f"n_bucket={r0.n_bucket} backend={r0.backend} "
        f"queue={r0.queue_s * 1e3:.2f}ms wave={r0.wave_s * 1e3:.2f}ms "
        f"latency={r0.latency_s * 1e3:.2f}ms "
        f"selection={[i for i, _ in r0.selection]}"
    )
    if a.metrics:
        print(json.dumps(server.stats.snapshot(), indent=2))


if __name__ == "__main__":
    main()
