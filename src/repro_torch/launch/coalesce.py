"""Request coalescing for the selection server (launch/serve.py).

Incoming selection requests are heterogeneous — different function families,
ground-set sizes, budgets — while the batched engine wants homogeneous
waves of equal shapes.  This module is the bridge (the JAX package's
``launch/coalesce.py``):

1. **pad**: each request's function is zero-padded along the candidate axis
   to a power-of-two bucket size (zero rows/columns have zero marginal gain
   for the supported families, so padding never changes the selection), with
   a per-request ``valid`` row masking the padding — or served at its own n
   where padding would merge no group (:func:`bucket_for`);
2. **group**: padded requests sharing (structure, tensor shapes, device,
   optimizer, stop flags) coalesce into waves of at most ``max_wave``;
3. **budgets**: a wave loops to its largest budget (instances freeze once
   their own budget is spent).  The JAX package rounds that bound up to a
   power of two so that waves of other budget mixes reuse one compiled
   program; the port runs eagerly, compiles nothing per bound, and would
   only sweep the frozen tail longer (up to 2x the steps).

The demultiplexing inverse lives on :class:`Wave`: results come back in wave
order and :meth:`Wave.demux` maps them to request ids.

**The backend gate.**  A function built with ``use_kernel=None`` picks the
CUDA kernel or the torch sweep by its ground-set size and device
(``backends.kernel_enabled``).  Padding changes the size, so a request of
n = 3,072 would cross ``KERNEL_MIN_N`` = 4,096 inside a wave and sum in
another order than its sequential solve.  :func:`pad_function` therefore
resolves ``None`` against the request's OWN n and device before it pads and
carries the resolved bool into the padded function; the bool is part of the
group key, so a wave's backend is the one its members' sequential solves
take.

Padding semantics are family-specific and registered in ``_PADDERS`` —
GraphCut (zero rows+columns, zero modular term), FeatureBased (zero feature
rows), SetCover / ProbabilisticSetCover (zero incidence rows, and zero
probabilities), DisparitySum / DisparityMin (zero rows+columns — padded
candidates are valid-masked and padded columns are never selected), LogDet
(zero rows+columns: a padded candidate's pivot is 0, so its gain is
NEG_INF), GCMI (zero query-sum entries), FLQMI (zero COLUMNS under its
fixed query rows; its sweep sums the rows in ``common.row_sums_fixed``'s
order, which does not depend on the column count).  FacilityLocation and
the FL measures FLVMI / FLCG / FLCMI are served at their own n: their
padded layout would keep their n represented rows, so padding would merge
no group.  The matrix-free families pad their
similarity SOURCE: GraphCutMF pads both axes (feature sources zero feature
rows, k-NN sources -1/0 rows, dense sources zero rows+columns);
FacilityLocationMF pads the candidate axis (zero feature rows, or a k-NN
source's column count) only where its represented rows are not its ground
set, and is otherwise served at its own n, as is a dense source.
``register_padder`` plugs in more families; unsupported ones raise a
``NotImplementedError`` naming it.

**On a mesh** (``launch/serve.py``, ``mesh=``) the sharded engine needs
every wave's n to divide over the data axis and its batch over the batch
axis, so the server passes the two axis sizes as ``n_multiple`` /
``b_multiple`` (the JAX package's names; both 1 off a mesh, where nothing
changes).  A bucket is the power of two rounded up to ``n_multiple``; the
FL family's own n is rounded up to it too, with zero COLUMNS under its
untouched rows (a candidate's gain is a fixed-order sum over the rows,
``common.row_sums_fixed``, so the pad columns change no other column's
bits, and the ``valid`` mask blocks them).  A FacilityLocationMF served at
its own n keeps it: it has no shard rule, so the mesh refuses its waves
anyway.  A wave's batch is padded to ``b_multiple`` with budget-0 copies of
its slot 0, dropped at demux; their ``valid`` rows follow slot 0's true n.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.functions.disparity import DisparityMin, DisparitySum
from repro_torch.core.functions.facility_location import FacilityLocation, FacilityLocationMF
from repro_torch.core.functions.feature_based import FeatureBased
from repro_torch.core.functions.graph_cut import GraphCut, GraphCutMF
from repro_torch.core.functions.log_det import LogDet
from repro_torch.core.functions.set_cover import ProbabilisticSetCover, SetCover
from repro_torch.core.info.fl import FLCG, FLCMI, FLQMI, FLVMI
from repro_torch.core.info.gc import GCMI
from repro_torch.core.optimizers.backends import backend_name
from repro_torch.core.optimizers.batched import _device_of, _structure
from repro_torch.core.optimizers.spec import OptimizerSpec, SelectionSpec
from repro_torch.core.sources import DenseSource, FeatureSource, KnnSource
from repro_torch.launch import faults

# The serving stack's one clock (monotonic seconds): arrival stamps, queue
# and wave times, deadlines and retry timeouts all read it, through this
# module attribute, so a test can replace it.
clock: Callable[[], float] = time.monotonic


@dataclasses.dataclass
class SelectionRequest:
    """One enqueued query: a request id plus its :class:`SelectionSpec`.

    The request IS the spec — serving adds only routing identity (``rid``)
    and arrival time (``enqueue_t``, from :data:`clock`, stamped at
    construction), so a response reports the time the *client* waited
    (queue + dispatch), not just its wave's dispatch wall time.
    """

    rid: int | str
    spec: SelectionSpec
    enqueue_t: float = dataclasses.field(default_factory=lambda: clock())

    @property
    def fn(self):
        """The function with the spec's backend choice applied."""
        return self.spec.resolved_fn()

    @property
    def budget(self) -> int:
        return self.spec.budget

    @property
    def deadline_t(self) -> Optional[float]:
        """Absolute deadline (``enqueue_t + spec.deadline_s``), or None when
        the request carries no deadline."""
        if self.spec.deadline_s is None:
            return None
        return self.enqueue_t + self.spec.deadline_s


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def round_up(n: int, multiple: int) -> int:
    return -(-int(n) // int(multiple)) * int(multiple)


def bucket_size(n: int, multiple: int = 1) -> int:
    """Power-of-two bucket >= n, rounded up to a multiple (the mesh data-axis
    size, so sharded waves always divide evenly)."""
    return round_up(next_pow2(n), multiple)


# ---------------------------------------------------------------------------
# Family padders: fn, n_to -> equivalent instance over a padded ground set.
# ---------------------------------------------------------------------------

def _pad(t: torch.Tensor, shape: tuple, value=0) -> torch.Tensor:
    """``t`` placed at the origin of a ``value``-filled tensor of ``shape``."""
    out = t.new_full(shape, value)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def _pad_rows(t: torch.Tensor, n_to: int, value=0) -> torch.Tensor:
    return _pad(t, (n_to,) + tuple(t.shape[1:]), value)


def _pad_cols(t: torch.Tensor, n_to: int) -> torch.Tensor:
    return _pad(t, (t.shape[0], n_to))


def _pad_square(t: torch.Tensor, n_to: int) -> torch.Tensor:
    return _pad(t, (n_to, n_to))


def _unpadded(fn, n_to: int):
    """The refusal of a size other than the one a family served at its own n
    rides at (:func:`bucket_for`)."""
    raise ValueError(f"{type(fn).__name__} is served at its own n = {fn.n}, not padded to {n_to}")


def _pad_own_n(fn, n_to: int):
    """The FL family's padder: zero COLUMNS of ``sim`` under its untouched
    represented rows (the per-row ``qmax`` / ``pmax`` of the measures keep
    their length), used only to round its own n up to a mesh's data axis."""
    return dataclasses.replace(fn, sim=_pad_cols(fn.sim, n_to), n=n_to)


def _pad_gc(fn: GraphCut, n_to: int) -> GraphCut:
    return dataclasses.replace(
        fn, sim_ground=_pad_square(fn.sim_ground, n_to), total=_pad_rows(fn.total, n_to), n=n_to
    )


def _pad_fb(fn: FeatureBased, n_to: int) -> FeatureBased:
    return dataclasses.replace(fn, feats=_pad_rows(fn.feats, n_to), n=n_to)


def _pad_sc(fn: SetCover, n_to: int) -> SetCover:
    # zero incidence rows: a padded candidate covers nothing, so its gain is
    # exactly 0 and the valid mask blocks it; real candidates' gains are
    # per-row sums over the untouched concept axis.
    return dataclasses.replace(fn, cover=_pad_rows(fn.cover, n_to), n=n_to)


def _pad_psc(fn: ProbabilisticSetCover, n_to: int) -> ProbabilisticSetCover:
    # log(1 - p) = 0 and p = 0 rows: a padded candidate has gain 0
    return dataclasses.replace(
        fn, log_miss=_pad_rows(fn.log_miss, n_to), probs=_pad_rows(fn.probs, n_to), n=n_to
    )


def _pad_square_dist(fn, n_to: int):
    return dataclasses.replace(fn, dist=_pad_square(fn.dist, n_to), n=n_to)


def _pad_logdet(fn: LogDet, n_to: int) -> LogDet:
    # zero rows+columns: a padded candidate's pivot d2 starts (and stays) 0,
    # so its gain is NEG_INF; max_select is capacity, not ground size
    return dataclasses.replace(fn, L=_pad_square(fn.L, n_to), n=n_to)


def _pad_gcmi(fn: GCMI, n_to: int) -> GCMI:
    return dataclasses.replace(fn, qsum=_pad_rows(fn.qsum, n_to), n=n_to)


def _pad_flqmi(fn: FLQMI, n_to: int) -> FLQMI:
    # zero COLUMNS only, under the fixed query rows: a padded candidate's
    # gain is 0 + modular 0 and the valid mask blocks it
    return dataclasses.replace(
        fn, sim_qv=_pad_cols(fn.sim_qv, n_to), modular=_pad_rows(fn.modular, n_to), n=n_to
    )


def _pad_source_cols(src, n_to: int):
    """Pad a similarity source's CANDIDATE (column) axis only — the row axis
    is a sum-reduction axis and is never padded.  A dense source is never
    column-padded (:func:`bucket_for`)."""
    if isinstance(src, FeatureSource):
        clab = src.col_labels
        if clab is not None:
            clab = _pad_rows(clab, n_to, -1)
        return dataclasses.replace(
            src, y=_pad_rows(src.y, n_to), yy=_pad_rows(src.yy, n_to), col_labels=clab,
            n_cols=n_to,
        )
    if isinstance(src, KnnSource):
        # meta-only: the column count grows; indices / weights are untouched,
        # and a column's sum runs over its own entries alone
        return dataclasses.replace(src, n_cols=n_to)
    raise NotImplementedError(f"no column padder for source type {type(src).__name__}")


def _pad_source_square(src, n_to: int):
    """Pad a SQUARE ground-set source on both axes (Graph-Cut shape).

    Feature pad rows are zero-feature rows — their similarity to real
    points is generally nonzero (cosine midpoint, RBF at distance), but
    every read of those entries is blocked: pad candidates are
    valid-masked, pad columns carry selmask/total/diag 0, and ``col`` reads
    at pad rows only feed gains of pad candidates."""
    if isinstance(src, FeatureSource):
        y, yy = _pad_rows(src.y, n_to), _pad_rows(src.yy, n_to)
        lab = src.col_labels
        if lab is not None:
            lab = _pad_rows(lab, n_to, -1)
        return dataclasses.replace(
            src, x=y, y=y, xx=yy, yy=yy, row_labels=lab, col_labels=lab,
            n_rows=n_to, n_cols=n_to,
        )
    if isinstance(src, KnnSource):
        return dataclasses.replace(
            src, indices=_pad_rows(src.indices, n_to, -1), weights=_pad_rows(src.weights, n_to),
            n_rows=n_to, n_cols=n_to,
        )
    if isinstance(src, DenseSource):
        return dataclasses.replace(src, sim=_pad_square(src.sim, n_to), n_rows=n_to, n_cols=n_to)
    raise NotImplementedError(f"no square padder for source type {type(src).__name__}")


def _pad_flmf(fn: FacilityLocationMF, n_to: int) -> FacilityLocationMF:
    return dataclasses.replace(fn, src=_pad_source_cols(fn.src, n_to), n=n_to)


def _pad_gcmf(fn: GraphCutMF, n_to: int) -> GraphCutMF:
    return dataclasses.replace(
        fn,
        src=_pad_source_square(fn.src, n_to),
        total=_pad_rows(fn.total, n_to),
        diag=_pad_rows(fn.diag, n_to),
        n=n_to,
    )


_PADDERS: dict[type, Callable] = {
    FacilityLocation: _pad_own_n,
    GraphCut: _pad_gc,
    FeatureBased: _pad_fb,
    SetCover: _pad_sc,
    ProbabilisticSetCover: _pad_psc,
    DisparitySum: _pad_square_dist,
    DisparityMin: _pad_square_dist,
    LogDet: _pad_logdet,
    GCMI: _pad_gcmi,
    FLQMI: _pad_flqmi,
    FLVMI: _pad_own_n,
    FLCG: _pad_own_n,
    FLCMI: _pad_own_n,
    FacilityLocationMF: _pad_flmf,
    GraphCutMF: _pad_gcmf,
}


def register_padder(cls: type, padder: Callable) -> None:
    """Plug in ``padder(fn, n_to) -> fn_padded`` for a function family."""
    _PADDERS[cls] = padder


def resolve_padder(cls: type) -> Callable:
    """The padder serving ``cls`` (resolved along the MRO), or a
    ``NotImplementedError`` naming :func:`register_padder`.  The serving
    front door calls this at submit time so an unsupported family is
    rejected before it can poison a flush."""
    for klass in cls.__mro__:
        padder = _PADDERS.get(klass)
        if padder is not None:
            return padder
    raise NotImplementedError(
        f"{cls.__name__} has no registered padder, so it cannot be "
        "coalesced into served waves; plug one in via "
        "repro_torch.launch.coalesce.register_padder"
    )


def served_unpadded(fn) -> bool:
    """True where ``fn`` rides its wave at its own n: a family whose padded
    layout would keep an axis of its n rows (FacilityLocation and the FL
    measures; a FacilityLocationMF whose represented rows are its ground
    set, or over a dense source) keys its group on that n whatever the
    bucket, so padding would merge nothing and only widen its sweeps."""
    if resolve_padder(type(fn)) is _pad_own_n:
        return True
    if isinstance(fn, FacilityLocationMF):
        return isinstance(fn.src, DenseSource) or fn.src.n_rows == fn.n
    return False


def bucket_for(fn, n_multiple: int = 1) -> int:
    """The ground-set size ``fn`` rides a wave at: its own n where it is
    :func:`served_unpadded` (the FL family's rounded up to ``n_multiple``,
    the mesh's data axis), else the power-of-two bucket of n rounded up to
    ``n_multiple``."""
    if not served_unpadded(fn):
        return bucket_size(fn.n, n_multiple)
    if resolve_padder(type(fn)) is _pad_own_n:
        return round_up(fn.n, n_multiple)
    return fn.n


def resolve_gate(fn):
    """``fn`` with ``use_kernel=None`` replaced by the bool its own backend
    resolution takes at its own n and device (``kernel_enabled`` inside the
    family's ``gain_backend``); ``fn`` itself for an explicit flag or a
    family without one.  Padding must not move a request across the gate."""
    if getattr(fn, "use_kernel", False) is not None:
        return fn
    with faults.suspended():  # a bookkeeping probe, not a kernel boundary
        on = backend_name(fn) != "torch"
    return dataclasses.replace(fn, use_kernel=on)


def pad_function(fn, n_to: int, *, n_multiple: int = 1):
    """Zero-pad ``fn``'s candidate axis to ``n_to``, its backend gate
    resolved first (:func:`resolve_gate`); the gate-resolved ``fn`` itself
    when no padding is needed.  A family served at its own n takes only
    that n, rounded up to ``n_multiple`` (:func:`bucket_for`).

    The registry is consulted even when no padding is needed: a family
    without a padder must fail the same way at every ground-set size.  This
    is also the "padder" fault-injection boundary (``launch/faults.py``),
    which fires at exact bucket sizes too.  Padding happens at flush time,
    so a padder fault aborts a drain *before* any queue entry is removed
    (or, on the resilient drain, isolates just the failing group)."""
    padder = resolve_padder(type(fn))
    faults.check("padder", family=type(fn).__name__, n=fn.n, n_to=n_to)
    if fn.n > n_to:
        raise ValueError(f"cannot pad n={fn.n} down to {n_to}")
    fn = resolve_gate(fn)
    if served_unpadded(fn) and n_to != bucket_for(fn, n_multiple):
        return _unpadded(fn, n_to)
    if fn.n == n_to:
        return fn
    return padder(fn, n_to)


# ---------------------------------------------------------------------------
# Waves
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Wave:
    """A homogeneous batch of equal shapes, ready for the batched engine."""

    requests: list[SelectionRequest]  # the requests, in batch order
    fns: list  # their padded instances, in the same order
    valid: np.ndarray  # (B, n_bucket) bool
    budgets: list[int]  # per-member budgets
    max_budget: int  # loop bound: the largest budget
    optimizer: OptimizerSpec  # shared by the wave (hyperparameters included)
    stop_if_zero: bool
    stop_if_negative: bool
    n_bucket: int

    @property
    def batch_size(self) -> int:
        """Engine slots, batch pads included."""
        return len(self.fns)

    @property
    def n_padded_slots(self) -> int:
        """Batch-pad slots: budget-0 copies of slot 0 (a mesh's batch axis)."""
        return len(self.fns) - len(self.requests)

    @property
    def label(self) -> str:
        """Metrics label of the group that produced this wave — matches
        :func:`group_label` for every member request."""
        return (
            f"{type(self.requests[0].spec.fn).__name__}/n{self.n_bucket}"
            f"/{self.optimizer.name}"
        )

    def demux(self, results: Sequence) -> dict:
        """Map per-member engine results back to {rid: result}."""
        return {req.rid: results[i] for i, req in enumerate(self.requests)}


# -- group keys: wave identity, promoted to queue identity --------------------
#
# Requests sharing a group key can ride one engine dispatch, so the key is
# ALSO the identity of the serving front door's pending queues (continuous
# batching).  It must be cheap at submit time: the padded layout is found by
# padding a copy of the function whose tensors live on the meta device (no
# data, shapes only), memoized per (structure, tensor shapes, gate, n_bucket).

_LAYOUT_CACHE: dict = {}


def _tensors(obj):
    """The tensors of ``obj``'s tree, in field order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


def _to_meta(obj):
    """``obj`` with every tensor replaced by a meta tensor of its shape."""
    if isinstance(obj, torch.Tensor):
        return torch.empty(obj.shape, dtype=obj.dtype, device="meta")
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_meta(getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.init
        })
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_meta(v) for v in obj)
    return obj


def _padded_layout(fn, n_bucket: int, n_multiple: int = 1) -> tuple:
    """(structure, tensor shapes and dtypes) of ``pad_function(fn,
    n_bucket)``, found without touching any data."""
    fn = resolve_gate(fn)
    cache_key = (
        _structure(fn),
        tuple((tuple(t.shape), t.dtype) for t in _tensors(fn)),
        n_bucket,
        n_multiple,
    )
    layout = _LAYOUT_CACHE.get(cache_key)
    if layout is None:
        with faults.suspended():  # shapes only: not the padder boundary
            padded = pad_function(_to_meta(fn), n_bucket, n_multiple=n_multiple)
        layout = (
            _structure(padded),
            tuple((tuple(t.shape), t.dtype) for t in _tensors(padded)),
        )
        _LAYOUT_CACHE[cache_key] = layout
    return layout


def group_key(req: SelectionRequest, *, n_multiple: int = 1) -> tuple:
    """The (family, n-bucket) group identity of a request.

    Two requests with equal keys coalesce into the same wave: padded
    structure (which holds the resolved backend gate) + tensor shapes, their
    device, the (hashable) OptimizerSpec — hyperparameters ride along
    without being enumerated — and the stop flags.  Budgets and deadlines
    deliberately do NOT key: waves mix budgets under one loop bound, and a
    deadline shapes flush *scheduling*, never wave membership.
    """
    fn = req.fn  # the spec's backend choice applied
    structure, shapes = _padded_layout(fn, bucket_for(fn, n_multiple), n_multiple)
    spec = req.spec
    return (
        structure,
        shapes,
        str(_device_of(fn)),
        spec.optimizer,
        spec.stop_if_zero,
        spec.stop_if_negative,
    )


def group_label(req: SelectionRequest, *, n_multiple: int = 1) -> str:
    """Human-readable metrics label for the request's group:
    ``Family/n<bucket>/<Optimizer>`` (coarser than :func:`group_key` — leaf
    shapes beyond the n-bucket are folded away for readability)."""
    fn = req.spec.fn
    return (
        f"{type(fn).__name__}/n{bucket_for(fn, n_multiple)}"
        f"/{req.spec.optimizer.name}"
    )


def waves_for_group(
    requests: Sequence[SelectionRequest],
    *,
    max_wave: int = 64,
    n_multiple: int = 1,
    b_multiple: int = 1,
) -> list[Wave]:
    """Build dispatchable waves from requests sharing one :func:`group_key`
    (one queue's drain).  Padding is materialized HERE, at flush time —
    submit time only ever computes shapes.  ``n_multiple`` / ``b_multiple``
    round each n up and pad each batch to the mesh's data / batch axis."""
    members = []
    for req in requests:
        fn = req.fn
        members.append(
            (req, pad_function(fn, bucket_for(fn, n_multiple), n_multiple=n_multiple))
        )
    head = requests[0].spec
    waves = []
    for lo in range(0, len(members), max_wave):
        chunk = members[lo : lo + max_wave]
        reqs = [r for r, _ in chunk]
        fns = [f for _, f in chunk]
        budgets = [r.budget for r in reqs]
        # batch pads: budget-0 copies of slot 0, dropped at demux
        b_total = round_up(len(fns), b_multiple)
        fns = fns + [fns[0]] * (b_total - len(fns))
        budgets = budgets + [0] * (b_total - len(reqs))
        n_bucket = fns[0].n
        valid = np.zeros((b_total, n_bucket), bool)
        for i in range(b_total):
            valid[i, : reqs[i if i < len(reqs) else 0].spec.fn.n] = True
        waves.append(
            Wave(
                requests=reqs,
                fns=fns,
                valid=valid,
                budgets=budgets,
                max_budget=max(max(budgets), 1),
                optimizer=head.optimizer,
                stop_if_zero=head.stop_if_zero,
                stop_if_negative=head.stop_if_negative,
                n_bucket=n_bucket,
            )
        )
    return waves


def coalesce(
    requests: Sequence[SelectionRequest],
    *,
    max_wave: int = 64,
    n_multiple: int = 1,
    b_multiple: int = 1,
) -> list[Wave]:
    """Group requests into dispatchable waves, in first-arrival order of
    each group's earliest request.  The serving front door keeps per-group
    queues keyed by :func:`group_key` and drains them through
    :func:`waves_for_group` directly; this is the one-shot composition of
    the two for flat request lists.  ``n_multiple`` / ``b_multiple``: the
    mesh's data- and batch-axis sizes (1 off a mesh)."""
    groups: dict[tuple, list[SelectionRequest]] = {}
    for req in requests:
        groups.setdefault(group_key(req, n_multiple=n_multiple), []).append(req)
    waves = []
    for members in groups.values():
        waves.extend(waves_for_group(members, max_wave=max_wave, n_multiple=n_multiple,
                                     b_multiple=b_multiple))
    return waves
