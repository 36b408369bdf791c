"""Long-lived selection sessions over the serving front doors.

The JAX package's ``launch/sessions.py``, ported.  A
:class:`SelectionSession` is the serving shape for *growing* data: a client
opens a session around a :class:`~repro_torch.core.optimizers.spec.
SelectionSpec`, then feeds **deltas** — new ground-set rows, or newly
unlocked indices of a fixed universe — and receives an updated selection
after every delta:

    session = server.open_session(SelectionSpec(fn0, budget=8))
    upd = session.extend(features=new_rows)   # sync: SessionUpdate
    fut = session.extend(features=more_rows)  # async server: Future
    session.close()

Replay semantics (the determinism contract): each ``extend`` rebuilds the
session's function over the FULL stream seen so far and submits one fresh
spec through the server's normal per-group queues — deltas coalesce with
everyone else's requests, ride padded waves, and obey backpressure and
deadlines exactly like one-shot requests.  Because the k-th update *is*
``solve()`` over the concatenated stream, a session fed N deltas returns a
final selection bit-identical (ids, gains, n_evals) to one direct
``solve()`` over the same data, on or off a mesh (a mesh server's session
lives on rank 0 and its deltas ride the mesh waves) — there is no
incremental state to drift.

Two delta modes, fixed by the first ``extend``:

- **features mode** (``extend(features=rows)``): the spec's function seeds
  the stream and a registered *extender* appends rows.  Extenders MUST be
  concatenation-associative bit-for-bit — every built-in preprocesses rows
  independently (row-wise clamp / normalize / log1p), and a row's norm sums
  its squares in an order set by the feature width alone
  (``similarity_kernel.row_sq_norms``, the function the direct build uses
  too), so one big extend equals many small ones exactly, on the card as
  on the CPU.
- **indices mode** (``extend(indices=ids)``): the spec's function is the
  fixed universe and a registered *restrictor* exposes the active subset.
  Restrictors preserve values — the restricted function agrees with the
  universe function on every subset of the active set — and updates report
  UNIVERSE ids, not positions in the active list.

Families opt in through :func:`register_feature_extender` /
:func:`register_restrictor` (MRO-resolved, like the coalescer's padders,
so the info-measure subclasses of SetCover/PSC inherit coverage for free).

Session metrics ride the server's :class:`~repro_torch.launch.metrics.
ServerMetrics`: counters ``sessions_opened`` / ``sessions_closed`` /
``session_deltas`` / ``session_churn`` plus the ``delta_s`` histogram
(submit -> update latency per delta).  Each session also keeps its own
``deltas_absorbed`` / ``churn_total`` / ``last_update``.

Async edge discipline: ``extend`` on an :class:`~repro_torch.launch.
async_serve.AsyncSelectionServer` returns a Future chained onto the server's — a
``close(flush=False)`` on the server cancels the in-flight delta's future,
engine errors propagate as exceptional futures, and a full queue raises
:class:`~repro_torch.launch.serve.ServerOverloaded` synchronously at ``extend``
time (backpressure applies to deltas like any submit).

Crash safety: open a session with a :class:`SessionJournal` and every
COMMITTED delta's raw input (the float32 rows / the index array, exactly as
given) is appended to an atomic on-disk journal (one checkpoint step per
delta, riding ``repro_torch/ckpt/checkpoint.py``'s tmp + os.replace
discipline).
After a crash, :func:`restore_sessions` replays each journaled stream
through a fresh server's REAL ``extend`` path — re-preprocessing the raw
inputs identically — so the restored sessions' state (stream, active set,
selection, churn accounting) is bit-identical to the lost server's.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.common import as_float_tensor
from repro_torch.core.functions.facility_location import (
    FacilityLocation,
    FacilityLocationMF,
)
from repro_torch.core.functions.feature_based import FeatureBased
from repro_torch.core.functions.graph_cut import GraphCut
from repro_torch.core.functions.set_cover import ProbabilisticSetCover, SetCover, probs_of
from repro_torch.core.optimizers.batched import _device_of
from repro_torch.core.optimizers.spec import SelectionSpec
from repro_torch.core.sources import DenseSource, FeatureSource
from repro_torch.kernels.similarity_kernel import _normalize, row_sq_norms
from repro_torch.launch import faults
from repro_torch.launch.async_serve import AsyncSelectionServer

__all__ = [
    "SelectionSession",
    "SessionClosed",
    "SessionJournal",
    "SessionUpdate",
    "register_feature_extender",
    "register_restrictor",
    "resolve_extender",
    "resolve_restrictor",
    "restore_sessions",
]


class SessionClosed(RuntimeError):
    """``extend`` was called on a closed :class:`SelectionSession`."""


@dataclasses.dataclass
class SessionUpdate:
    """One absorbed delta: the refreshed selection plus its accounting.

    ``selection`` ids are always in the session's UNIVERSE space — stream
    positions for features mode, the caller's own indices for indices mode
    — so consecutive updates are directly comparable (``churn`` is the
    symmetric difference of consecutive id sets).
    """

    seq: int  # 1-based delta sequence number within the session
    selection: list  # [(universe_id, gain), ...] in pick order
    result: object  # the GreedyResult (== sequential solve over the stream)
    response: object  # the underlying SelectionResponse (wave accounting)
    n_total: int  # ground-set size after this delta
    n_delta: int  # elements this delta added
    churn: int  # |previous ids  ^  current ids|
    latency_s: float  # extend() -> update built (queue + wave + chaining)


# ---------------------------------------------------------------------------
# Family registries (MRO-resolved, like launch/coalesce.py's padders)
# ---------------------------------------------------------------------------

_EXTENDERS: dict[type, object] = {}
_RESTRICTORS: dict[type, object] = {}


def register_feature_extender(family: type):
    """Register ``extender(fn, rows) -> fn'`` for a function family.

    The extender appends ``rows`` (the family's natural raw input — feature
    rows, cover rows, probability rows) to ``fn``'s ground set.  It must be
    concatenation-associative bit-for-bit: preprocessing may only look at
    one row at a time, so feeding rows one-by-one builds the exact array
    one big concatenate would.
    """

    def deco(fn):
        _EXTENDERS[family] = fn
        return fn

    return deco


def register_restrictor(family: type):
    """Register ``restrictor(fn, active) -> fn'`` for a function family.

    ``active`` is an int64 tensor of universe ids on the function's
    device; the restricted function
    must agree with ``fn`` on every subset of ``active`` (restrict the
    CANDIDATE axis only — the represented side stays the full universe)."""

    def deco(fn):
        _RESTRICTORS[family] = fn
        return fn

    return deco


def _resolve(registry: dict, cls: type, register_name: str):
    for base in cls.__mro__:
        hook = registry.get(base)
        if hook is not None:
            return hook
    raise NotImplementedError(
        f"{cls.__name__} has no session support for this delta mode; "
        f"register a hook with repro_torch.launch.sessions.{register_name} "
        f"(supported: {sorted(c.__name__ for c in registry)})"
    )


def resolve_extender(cls: type):
    return _resolve(_EXTENDERS, cls, "register_feature_extender")


def resolve_restrictor(cls: type):
    return _resolve(_RESTRICTORS, cls, "register_restrictor")


# -- built-in extenders ------------------------------------------------------


@register_feature_extender(FeatureBased)
def _extend_feature_based(fn: FeatureBased, rows) -> FeatureBased:
    # same row-wise clamp as from_features, so session-grown == direct-built
    rows = torch.clamp(as_float_tensor(rows, fn.feats.device), min=0.0)
    feats = torch.cat([fn.feats, rows], dim=0)
    return dataclasses.replace(fn, feats=feats, n=int(feats.shape[0]))


@register_feature_extender(SetCover)
def _extend_set_cover(fn: SetCover, rows) -> SetCover:
    cover = torch.cat([fn.cover, as_float_tensor(rows, fn.cover.device)], dim=0)
    return dataclasses.replace(fn, cover=cover, n=int(cover.shape[0]))


@register_feature_extender(ProbabilisticSetCover)
def _extend_psc(fn: ProbabilisticSetCover, rows) -> ProbabilisticSetCover:
    # rows are raw coverage PROBABILITIES — the same clip + log1p (and the
    # same 1 - exp) as from_probs, applied per row
    log_miss = torch.clamp(as_float_tensor(rows, fn.log_miss.device), 0.0, 1.0 - 1e-7)
    log_miss.neg_().log1p_()
    return dataclasses.replace(
        fn,
        log_miss=torch.cat([fn.log_miss, log_miss], dim=0),
        probs=torch.cat([fn.probs, probs_of(log_miss)], dim=0),
        n=int(fn.n + log_miss.shape[0]),
    )


def _is_symmetric(src: FeatureSource) -> bool:
    """Self-represented source (feature_source(x, y=None))?  Identity is the
    fast path; after transformations fall back to an exact compare."""
    if src.x is src.y:
        return True
    return (
        src.n_rows == src.n_cols
        and src.x.shape == src.y.shape
        and bool(torch.equal(src.x, src.y))
    )


@register_feature_extender(FacilityLocationMF)
def _extend_fl_mf(fn: FacilityLocationMF, rows) -> FacilityLocationMF:
    src = fn.src
    if not isinstance(src, FeatureSource):
        raise NotImplementedError(
            "session extension of FacilityLocationMF needs a FeatureSource "
            f"(raw rows can be appended); got {type(src).__name__}"
        )
    if src.row_labels is not None or src.col_labels is not None:
        raise NotImplementedError(
            "clustered (label-masked) sources cannot be extended in a session"
        )
    # exactly feature_source's row-wise preprocessing (normalize for cosine,
    # then squared norms), each row's sums in an order set by d alone —
    # concat-associative by construction
    d32 = as_float_tensor(rows, src.device)
    if src.metric == "cosine":
        d32 = _normalize(d32)
    d32 = d32.contiguous()
    dd = row_sq_norms(d32)
    if _is_symmetric(src):
        x = torch.cat([src.x, d32], dim=0)
        xx = torch.cat([src.xx, dd], dim=0)
        new_src = dataclasses.replace(
            src, x=x, y=x, xx=xx, yy=xx,
            n_rows=int(x.shape[0]), n_cols=int(x.shape[0]),
        )
    else:  # fixed represented rows, growing candidate columns
        y = torch.cat([src.y, d32], dim=0)
        yy = torch.cat([src.yy, dd], dim=0)
        new_src = dataclasses.replace(src, y=y, yy=yy, n_cols=int(y.shape[0]))
    return dataclasses.replace(fn, src=new_src, n=new_src.n_cols)


# -- built-in restrictors (candidate axis only: values are preserved) --------


@register_restrictor(FacilityLocation)
def _restrict_fl(fn: FacilityLocation, active) -> FacilityLocation:
    return dataclasses.replace(
        fn, sim=fn.sim.index_select(1, active), n=int(active.shape[0])
    )


@register_restrictor(FacilityLocationMF)
def _restrict_fl_mf(fn: FacilityLocationMF, active) -> FacilityLocationMF:
    src = fn.src
    if isinstance(src, DenseSource):
        sub = dataclasses.replace(
            src, sim=src.sim.index_select(1, active), n_cols=int(active.shape[0])
        )
    elif isinstance(src, FeatureSource):
        sub = dataclasses.replace(
            src,
            y=src.y.index_select(0, active),
            yy=src.yy.index_select(0, active),
            col_labels=(
                None if src.col_labels is None else src.col_labels.index_select(0, active)
            ),
            n_cols=int(active.shape[0]),
        )
    else:
        raise NotImplementedError(
            "session restriction of FacilityLocationMF needs a FeatureSource "
            f"or DenseSource; got {type(src).__name__}"
        )
    return dataclasses.replace(fn, src=sub, n=int(active.shape[0]))


@register_restrictor(GraphCut)
def _restrict_gc(fn: GraphCut, active) -> GraphCut:
    # representation term stays over the full universe (total gathered),
    # the S x S penalty only ever reads active x active
    sub = fn.sim_ground.index_select(0, active).index_select(1, active)
    return dataclasses.replace(
        fn, sim_ground=sub, total=fn.total.index_select(0, active), n=int(active.shape[0])
    )


@register_restrictor(FeatureBased)
def _restrict_fb(fn: FeatureBased, active) -> FeatureBased:
    return dataclasses.replace(
        fn, feats=fn.feats.index_select(0, active), n=int(active.shape[0])
    )


@register_restrictor(SetCover)
def _restrict_sc(fn: SetCover, active) -> SetCover:
    return dataclasses.replace(
        fn, cover=fn.cover.index_select(0, active), n=int(active.shape[0])
    )


@register_restrictor(ProbabilisticSetCover)
def _restrict_psc(fn: ProbabilisticSetCover, active) -> ProbabilisticSetCover:
    return dataclasses.replace(
        fn,
        log_miss=fn.log_miss.index_select(0, active),
        probs=fn.probs.index_select(0, active),
        n=int(active.shape[0]),
    )


# ---------------------------------------------------------------------------
# Crash-safe journaling
# ---------------------------------------------------------------------------


class SessionJournal:
    """Append-only on-disk journal of session deltas.

    Layout: ``root/<sid>/step_<seq>/`` — one checkpoint step per committed
    delta, written through :mod:`repro_torch.ckpt.checkpoint`'s atomic
    tmp + ``os.replace`` discipline, so a crash mid-append never corrupts
    an already-journaled delta.  What is journaled is the delta's RAW input
    (the float32 feature rows, or the index array exactly as the client
    gave it), NOT the preprocessed function state: replay re-runs the real
    ``extend`` path, so restored state is bit-identical by construction
    rather than by trusting a serialized snapshot.
    """

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def append(self, sid: str, seq: int, mode: str, payload) -> None:
        """Journal one committed delta (``seq`` is the session's 1-based
        delta ordinal)."""
        from repro_torch.ckpt import checkpoint

        checkpoint.save(
            os.path.join(self.root, sid),
            seq,
            {"payload": _host(payload)},
            meta={"sid": sid, "seq": int(seq), "mode": mode},
            keep_last=10**9,  # a journal never prunes
        )

    def sessions(self) -> list[str]:
        """Session ids with at least one journaled delta, sorted."""
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        out = []
        for name in sorted(names):
            sid_dir = os.path.join(self.root, name)
            if os.path.isdir(sid_dir) and any(
                d.startswith("step_") and not d.endswith(".tmp")
                for d in os.listdir(sid_dir)
            ):
                out.append(name)
        return out

    def deltas(self, sid: str) -> list[dict]:
        """The session's journaled deltas in commit order:
        ``[{"seq", "mode", "payload"}, ...]``."""
        from repro_torch.ckpt import checkpoint

        sid_dir = os.path.join(self.root, sid)
        if not os.path.isdir(sid_dir):
            return []
        seqs = sorted(
            int(d.split("_")[1])
            for d in os.listdir(sid_dir)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        out = []
        for seq in seqs:
            tree, meta = checkpoint.restore(sid_dir, {"payload": 0}, step=seq)
            out.append(
                {
                    "seq": int(meta["seq"]),
                    "mode": meta["mode"],
                    "payload": np.asarray(tree["payload"]),
                }
            )
        return out


def restore_sessions(server, journal: SessionJournal, specs: dict) -> dict:
    """Rebuild every journaled session on a fresh ``server`` by replaying
    each stream through the REAL ``extend`` path.

    ``specs`` maps sid -> the base :class:`SelectionSpec` the session was
    opened around (specs hold live function objects, so the journal cannot
    reconstruct them itself; rebuild them from your own config).  Returns
    ``{sid: SelectionSession}`` — each replayed to the exact state the lost
    server held: same stream, same selection (ids / gains / n_evals), same
    ``seq``.  Replayed deltas are NOT re-journaled (the journal already has
    them) and do not consult fault plans — recovery itself is not a fault
    boundary.
    """
    restored: dict = {}
    for sid in journal.sessions():
        if sid not in specs:
            raise KeyError(
                f"journal has session {sid!r} but specs= does not; pass its "
                f"base SelectionSpec to replay it"
            )
        session = SelectionSession(server, specs[sid], sid=sid, journal=journal)
        session._replaying = True
        try:
            with faults.suspended():  # recovery is not a fault boundary
                for delta in journal.deltas(sid):
                    if delta["seq"] != session._seq + 1:
                        raise RuntimeError(
                            f"journal for session {sid!r} is not contiguous: "
                            f"expected seq {session._seq + 1}, got {delta['seq']}"
                        )
                    kw = (
                        {"features": delta["payload"]}
                        if delta["mode"] == "features"
                        else {"indices": delta["payload"]}
                    )
                    upd = session.extend(**kw)
                    if isinstance(upd, Future):  # async: force the wave now
                        server.flush_now()
                        upd.result()
        finally:
            session._replaying = False
        restored[sid] = session
    return restored


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------


class SelectionSession:
    """Per-client state across waves: the stream so far, the id mapping,
    and churn accounting.  Build one with ``server.open_session(spec)``.

    Thread-safety: stream order is submission order — ``extend`` mutates
    the accumulated stream and submits under one lock, so concurrent
    extends serialize into a well-defined stream.  Async completions
    (churn bookkeeping) take the same lock.

    ``sid`` names the session (auto-generated when omitted); with a
    ``journal``, every committed delta's raw input is appended under that
    sid so :func:`restore_sessions` can replay the session after a crash.
    A delta is journaled when it COMMITS (enqueued into the server), before
    its dispatch resolves — a delta whose dispatch later fails stays both
    committed and journaled, matching the stream semantics (the failed
    extend raised, but the stream already advanced; replay reproduces that
    state exactly).
    """

    # the public accounting attrs (deltas_absorbed / churn_total /
    # last_update) are benign snapshot reads and stay undeclared
    _GUARDED_BY = {
        "_mode": "_lock",
        "_fn": "_lock",
        "_active": "_lock",
        "_seen": "_lock",
        "_prev_ids": "_lock",
        "_seq": "_lock",
        "_closed": "_lock",
    }

    _SID_COUNTER = itertools.count()

    def __init__(
        self,
        server,
        spec: SelectionSpec,
        *,
        sid: str | None = None,
        journal: "SessionJournal | None" = None,
    ):
        if not isinstance(spec, SelectionSpec):
            raise TypeError(
                f"open_session() takes a SelectionSpec, got {type(spec).__name__!r}"
            )
        self.sid = (
            sid if sid is not None else f"s{next(SelectionSession._SID_COUNTER)}"
        )
        self._journal = journal
        self._replaying = False  # restore_sessions: suppress re-journaling
        self._server = server
        self._async = isinstance(server, AsyncSelectionServer)
        self._metrics = server.metrics
        self._spec = spec
        self._lock = threading.Lock()
        self._mode: str | None = None  # "features" | "indices", set by 1st extend
        self._fn = spec.fn  # features mode: the concatenated-stream function
        self._active: list[int] = []  # indices mode: universe ids, arrival order
        self._seen: set[int] = set()
        self._prev_ids: set = set()
        self._seq = 0
        self._closed = False
        self.deltas_absorbed = 0
        self.churn_total = 0
        self.last_update: SessionUpdate | None = None
        self._metrics.inc("sessions_opened")

    # -- client API ----------------------------------------------------------

    @property
    def mode(self) -> str | None:
        return self._mode  # a benign racy snapshot read, for observability

    @property
    def closed(self) -> bool:
        return self._closed  # a benign racy snapshot read, for observability

    def extend(self, features=None, indices=None):
        """Absorb one delta and re-select over the full stream.

        Exactly one of ``features`` (new raw rows for the session family's
        extender) or ``indices`` (universe ids to unlock; repeats are
        ignored) must be given; the first call fixes the session's mode.
        Returns a :class:`SessionUpdate` on a sync server, or a Future
        resolving to one on an async server (cancelled if the server drops
        the delta via ``close(flush=False)``).  Raises
        :class:`~repro_torch.launch.serve.ServerOverloaded` synchronously when
        the server applies backpressure.
        """
        if (features is None) == (indices is None):
            raise TypeError("extend() takes exactly one of features= or indices=")
        want = "features" if features is not None else "indices"
        t0 = time.monotonic()
        with self._lock:
            if self._closed:
                raise SessionClosed("extend() on a closed SelectionSession")
            if self._mode is not None and self._mode != want:
                raise ValueError(
                    f"session is in {self._mode!r} mode; extend() cannot "
                    f"switch to {want!r} deltas"
                )
            # the "session-extend" fault boundary: fires BEFORE the delta is
            # built, so an injected fault leaves the stream untouched (the
            # retryable position — the client re-extends)
            faults.check(
                "session-extend",
                session=self.sid,
                seq=self._seq + 1,
                mode=want,
                family=type(self._spec.fn).__name__,
            )
            # build the delta WITHOUT committing, submit, then commit — so a
            # failed extend (unsupported family, ServerOverloaded) leaves the
            # stream untouched and a retry cannot double-append the delta
            if want == "features":
                # rows stay where the caller built them (a tensor on the
                # card is never copied to the host); numpy input is fp32
                rows = (features.to(torch.float32) if isinstance(features, torch.Tensor)
                        else np.asarray(features, np.float32))
                n_delta = int(rows.shape[0])
                fn = (
                    resolve_extender(type(self._fn))(self._fn, rows)
                    if n_delta
                    else self._fn
                )
                active = None
                n_total = int(fn.n)
            else:
                raw_idx = _host(indices).astype(np.int64).reshape(-1)
                fresh = []
                for i in raw_idx:
                    i = int(i)
                    if not 0 <= i < self._spec.fn.n:
                        raise ValueError(
                            f"index {i} outside the universe "
                            f"[0, {self._spec.fn.n})"
                        )
                    if i not in self._seen and i not in fresh:
                        fresh.append(i)
                if not self._active and not fresh:
                    raise ValueError(
                        "the first indices delta must unlock at least one "
                        "universe element"
                    )
                n_delta = len(fresh)
                active = np.asarray(self._active + fresh, np.int64)
                universe = self._spec.fn
                fn = resolve_restrictor(type(universe))(
                    universe, torch.as_tensor(active, device=_device_of(universe))
                )
                n_total = int(active.shape[0])
            spec = SelectionSpec(
                fn,
                min(self._spec.budget, n_total),
                self._spec.optimizer,
                stopIfZeroGain=self._spec.stop_if_zero,
                stopIfNegativeGain=self._spec.stop_if_negative,
                use_kernel=self._spec.use_kernel,
                deadline_s=self._spec.deadline_s,
                retry=self._spec.retry,  # deltas inherit the session's policy
            )
            if self._async:
                inner = self._server.submit(spec)  # may raise ServerOverloaded
            else:
                rid = self._server.submit_spec(spec)  # ditto
                inner = None
            # the delta is enqueued: commit it to the session's stream
            self._mode = want
            if want == "features":
                self._fn = fn
            else:
                self._seen.update(fresh)
                self._active.extend(fresh)
            seq = self._seq = self._seq + 1
            if self._journal is not None and not self._replaying:
                # journal the committed delta's RAW input — replay will
                # re-preprocess it through this same extend path
                self._journal.append(
                    self.sid, seq, want, rows if want == "features" else raw_idx
                )
        if not self._async:
            out = self._server.flush()
            resp = out.pop(rid, None)
            self._server.hold_undelivered(out)  # co-travellers' answers
            if resp is None:
                # resilient flush: the delta exhausted its retries and
                # resolved to a typed failure instead of a response
                fails = self._server.take_failures()
                err = fails.pop(rid, None)
                if fails:
                    self._server.hold_failures(fails)  # not ours to consume
                if err is None:
                    raise KeyError(
                        f"flush returned no response for session delta {rid!r}"
                    )
                raise err
            return self._absorb(resp, seq, n_total, n_delta, active, t0)

        out: Future = Future()

        def _chain(done: Future):
            if done.cancelled():
                out.cancel()
                return
            exc = done.exception()
            if exc is not None:
                out.set_exception(exc)
                return
            try:
                upd = self._absorb(done.result(), seq, n_total, n_delta, active, t0)
            except BaseException as e:  # never strand the chained future
                out.set_exception(e)
                return
            out.set_result(upd)

        inner.add_done_callback(_chain)
        return out

    def close(self) -> None:
        """Mark the session closed (idempotent).  In-flight async deltas
        still resolve; further ``extend`` calls raise
        :class:`SessionClosed`."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._metrics.inc("sessions_closed")

    def __enter__(self) -> "SelectionSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals -----------------------------------------------------------

    def _absorb(self, resp, seq, n_total, n_delta, active, t0) -> SessionUpdate:
        if active is None:  # features mode: ids are already stream positions
            selection = [(int(j), float(g)) for j, g in resp.selection]
        else:  # indices mode: map active-list positions back to universe ids
            selection = [(int(active[j]), float(g)) for j, g in resp.selection]
        latency = time.monotonic() - t0
        ids = {j for j, _ in selection}
        with self._lock:
            churn = len(self._prev_ids ^ ids)
            self._prev_ids = ids
            self.deltas_absorbed += 1
            self.churn_total += churn
            upd = SessionUpdate(
                seq=seq,
                selection=selection,
                result=resp.result,
                response=resp,
                n_total=n_total,
                n_delta=n_delta,
                churn=churn,
                latency_s=latency,
            )
            self.last_update = upd
        self._metrics.observe_delta(latency, churn=churn)
        return upd


def _host(a) -> np.ndarray:
    """``a`` as a host numpy array (a tensor is copied off its device)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
