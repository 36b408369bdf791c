"""Distributed greedies over a device mesh, on ``torch.distributed``.

Two layers live here, as in the JAX package:

1. The per-function partition greedies (:func:`distributed_fl_greedy` and
   friends): the ground set (kernel columns) sharded over the data axes,
   the represented set (kernel rows) over the model axis.
2. The generic **sharded batched engine**: a wave of B functions with the
   batch sharded over one mesh axis and every member's candidate axis over
   another.  Function families plug in through :class:`ShardRule` adapters
   (:func:`register_shard_rule`), and each shard's gain sweep routes
   through ``backends.full_sweep_wave`` / ``partial_sweep_wave`` on
   candidate-sliced local instances, so the CUDA sweeps (full and gathered)
   serve each shard.  Two step programs share the adapters:
   :func:`sharded_batched_greedy` (full sweeps and an O(1) winner election)
   and :func:`sharded_batched_lazy` (the bucketed lazy engine: merged
   stale-bound prefixes and gathered sweeps on the owning shards).

**Execution model.**  The JAX package runs one controller over a
``jax.sharding.Mesh`` and ``shard_map``.  Here every rank is its own
process (SPMD): each calls the entry point with the same global functions,
slices its own shard *once* into contiguous tensors on its device, and
takes part in the collectives of its axis groups.  :func:`make_mesh`
builds the mesh (a ``DeviceMesh`` with named dimensions) and one process
group, with a timeout, per tuple of its dimensions; a sharded axis may span
several dimensions (``col_axes=("pod", "data")``).  The JAX collectives map
onto helpers over those groups: ``psum`` / ``pmax`` / ``pmin`` onto
``all_reduce`` (SUM / MAX / MIN; ``pmin`` on the int64 ids) and the tiled
``all_gather`` onto ``all_gather_into_tensor``, blocks in flat shard-index
order.  NCCL runs them on the card; ``gloo`` (several ranks on one card)
takes card tensors for each of them as they are.  A failed collective
raises; nothing here falls back to one device.

**Gloo on the card.**  DTensor gathers a split dim (Shard -> Replicate)
through the functional collectives' ``all_gather_into_tensor``, whose
work torch 2.11's gloo dies on (SIGSEGV in ``wait_tensor``, on CUDA
tensors only; ``tools/gloo_cuda_probe.py`` shows which collectives come
back).  :func:`make_mesh` over gloo on the card installs
:func:`gather_without_work` as that operator's CUDA kernel: the same
gather through ``dist.all_gather_into_tensor``, which comes back, bit for
bit its result, with no work left for ``wait_tensor`` to wait on.
It stays only while that fault does: when the probe's unrepaired
``funcol_all_gather`` case, which ``chip_smoke.py`` phase 17 (bb) prints
before its gloo ranks start, exits 0 on the card's torch, the repair, its
install here and the probe's ``repaired_*`` cases go together.

**The bit contract.**  Rows and features are never split in the engine,
so each candidate's gain is the float reduction it is on one device
(provided the family's sweep sums a candidate in an order of its own: the
FL-family torch sweeps fold their rows in ``common.row_sums_fixed``'s
order for this); the first-index global argmax is recovered exactly by a
local argmax, ``pmax`` of the gain and ``pmin`` of the global id; the
winner's broadcast is a ``psum`` in which one shard contributes and the
others add exact zeros.  So every member equals its sequential solve bit
for bit: ids, gains, ``n_evals`` and value.

Each rank's per-step collective payload is O(stat) + O(1), independent of
the ground-set size: per NaiveGreedy step a ``pmax``, a ``pmin`` and at
most one ``psum`` of the winners' rows; per LazyGreedy level one
``all_gather`` of the level's sorted prefixes and one ``psum`` of the
screened gains, plus the winners' ``psum`` a step.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import warnings
import weakref
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.common import NEG_INF, resolve_device
from repro_torch.core.optimizers.backends import (
    full_sweep_wave,
    kernel_enabled,
    partial_sweep_wave,
)
from repro_torch.core.optimizers.greedy import (
    GreedyResult,
    _sample_unselected,
    _screen_levels,
    _should_stop,
    _step_keys,
    _where_state,
    member_values,
)

__all__ = [
    "make_mesh",
    "gather_without_work",
    "install_gather_without_work",
    "distributed_fl_greedy",
    "distributed_stochastic_fl_greedy",
    "distributed_flqmi_greedy",
    "ShardRule",
    "register_shard_rule",
    "shard_rule",
    "ShardedWave",
    "sharded_batched_greedy",
    "sharded_batched_lazy",
]

# the winner election's sentinel id; ids are int64, as the engines' are
_INT_MAX = 2**31 - 1
# every process group make_mesh builds gives up on a collective after this
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


# ---------------------------------------------------------------------------
# The mesh, its axis groups and the collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _MeshInfo:
    device: torch.device
    # sorted tuple of mesh dimensions -> the group of this rank's coset
    groups: dict
    timeout: datetime.timedelta = DEFAULT_TIMEOUT  # every group's
    axes: dict = dataclasses.field(default_factory=dict)  # memo of _axis


# id(mesh) -> _MeshInfo, dropped when the mesh is collected
_MESHES: dict[int, _MeshInfo] = {}


def _rank_device(device) -> torch.device:
    """``device`` when given, else this rank's card: ``cuda:(local_rank %
    device_count)``, so several ranks may share one card."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def gather_without_work(inp: torch.Tensor, group_size: int, group_name: str) -> torch.Tensor:
    """``_c10d_functional.all_gather_into_tensor`` through
    ``dist.all_gather_into_tensor``: ``group_size`` blocks of ``inp`` along
    dim 0, in group-rank order, gathered before it returns; no work is
    registered, so ``wait_tensor`` returns the result as it is."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    inp = inp.contiguous()
    out = inp.new_empty((group_size * inp.shape[0],) + tuple(inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp, group=_resolve_process_group(group_name))
    return out


# device type -> the library that holds the kernel; kept for the process
_GATHER_LIBS: dict[str, Any] = {}


def install_gather_without_work(device_type: str = "cuda") -> None:
    """Make :func:`gather_without_work` the functional all-gather's kernel
    for tensors on ``device_type`` in this process (once; later calls do
    nothing).  :func:`make_mesh` installs it for gloo on the card, against
    torch 2.11's gloo dying (SIGSEGV) in ``wait_tensor`` after that
    operator's own kernel.

    It replaces torch's kernel of ``_c10d_functional.all_gather_into_tensor``
    for the rest of the process and for every group there, an NCCL one
    too: each functional all-gather on such tensors is then a
    ``dist.all_gather_into_tensor`` that has gathered when it returns.
    Remove it when ``tools/gloo_cuda_probe.py funcol_all_gather`` (printed
    by ``chip_smoke.py`` phase 17 (bb)) comes back on the card's torch."""
    if device_type not in _GATHER_LIBS:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", gather_without_work, device_type.upper())
        _GATHER_LIBS[device_type] = lib


def make_mesh(shape: Sequence[int], names: Sequence[str], device=None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """A ``DeviceMesh`` of ``shape`` with dimensions ``names`` over the
    default process group (``jax.make_mesh``'s counterpart).

    Every rank must call it, with the same arguments, after
    ``torch.distributed.init_process_group``.  ``device`` is where this
    rank's shards live: the CPU, or by default the card
    ``cuda:(local_rank % device_count)`` (several ranks may share one card
    over the ``gloo`` backend; NCCL takes one rank per card).  One process
    group is built here for every tuple of dimensions, each with
    ``timeout``: a rank that dies or diverges makes the others raise within
    it rather than hang.  Over gloo on the card it installs
    :func:`install_gather_without_work` (DTensor's gathers)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group(...) on every rank first"
        )
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in length")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(
            f"mesh shape {shape} holds {math.prod(shape)} ranks, the world has "
            f"{dist.get_world_size()}"
        )
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if dist.get_backend() == "gloo":
            install_gather_without_work("cuda")
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=names)
    layout, me = mesh.mesh, dist.get_rank()
    groups = {}
    # every rank creates every group, in the same order
    for r in range(1, len(shape) + 1):
        for dims in itertools.combinations(range(len(shape)), r):
            rest = [d for d in range(len(shape)) if d not in dims]
            cosets = layout.permute(*rest, *dims).reshape(-1, math.prod(shape[d] for d in dims))
            for ranks in cosets.tolist():
                g = dist.new_group(ranks=ranks, timeout=timeout)
                if me in ranks:
                    groups[dims] = g
    _MESHES[id(mesh)] = _MeshInfo(device=dev, groups=groups, timeout=timeout)
    weakref.finalize(mesh, _MESHES.pop, id(mesh), None)
    return mesh


def _info(mesh) -> _MeshInfo:
    info = _MESHES.get(id(mesh))
    if info is None:
        raise TypeError(
            "mesh= must be a DeviceMesh built by "
            "repro_torch.core.optimizers.distributed.make_mesh (it builds the "
            f"axis groups the collectives run over); got {type(mesh).__name__!r}"
        )
    return info


@dataclasses.dataclass(frozen=True)
class _Axis:
    """A (possibly multi-dimensional) mesh axis as this rank sees it."""

    group: Any  # the process group of this rank's coset; None for no axes
    size: int
    index: int  # this rank's flat index over the axes, in their given order
    order: tuple | None  # group rank of each flat index; None when equal


def _axis(mesh, axes: Sequence[str]) -> _Axis:
    """The group, size and this rank's flat index of ``axes`` (the JAX
    package's ``_flat_axis_index``: the first axis varies slowest)."""
    info = _info(mesh)
    axes = tuple(axes)
    if axes in info.axes:
        return info.axes[axes]
    names = tuple(mesh.mesh_dim_names)
    for a in axes:
        if a not in names:
            raise ValueError(f"mesh has no axis {a!r} (axes: {names})")
    if not axes:
        return _Axis(None, 1, 0, None)
    dims = [names.index(a) for a in axes]
    sizes = tuple(mesh.mesh.shape)

    def flat(coord) -> int:
        f = 0
        for d in dims:
            f = f * sizes[d] + coord[d]
        return f

    group = info.groups[tuple(sorted(dims))]
    size = math.prod(sizes[d] for d in dims)
    by_rank = sorted(dist.get_process_group_ranks(group),
                     key=lambda r: dist.get_group_rank(group, r))
    flats = [flat((mesh.mesh == r).nonzero()[0].tolist()) for r in by_rank]
    order = tuple(flats.index(f) for f in range(size))
    ax = _Axis(
        group=group,
        size=size,
        index=flat(mesh.get_coordinate()),
        order=None if order == tuple(range(size)) else order,
    )
    info.axes[axes] = ax
    return ax


def _reduce(x: torch.Tensor, op, ax: _Axis) -> torch.Tensor:
    """``x`` reduced over ``ax`` in place (``x`` is a fresh temporary)."""
    if ax.group is not None:
        dist.all_reduce(x, op=op, group=ax.group)
    return x


def psum(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    return _reduce(x.contiguous().clone(), dist.ReduceOp.SUM, ax)


def pmax(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    return _reduce(x.contiguous().clone(), dist.ReduceOp.MAX, ax)


def pmin(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    return _reduce(x.contiguous().clone(), dist.ReduceOp.MIN, ax)


def _all_gather_cols(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """(..., k) -> (..., size * k): the shards' blocks concatenated along the
    last axis in flat shard-index order (the tiled ``all_gather``)."""
    if ax.group is None:
        return x
    x = x.contiguous()
    out = x.new_empty((ax.size * x.numel(),))
    with warnings.catch_warnings():
        # newer torch deprecates the name for all_gather_single, which the
        # older torch of some deployments lacks
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.reshape(-1), group=ax.group)
    out = out.reshape((ax.size,) + tuple(x.shape))
    if ax.order is not None:
        out = out[list(ax.order)]
    return out.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (ax.size * x.shape[-1],))


def _local_block(t, mesh, dim_axes: Sequence[tuple], device) -> torch.Tensor:
    """This rank's contiguous block of the global tensor ``t``, dimension d
    sharded over the mesh axes ``dim_axes[d]`` (empty: replicated), on
    ``device``: bf16 stays bf16, any other type becomes fp32.  A ``DTensor``
    already sharded so on ``mesh`` gives its local tensor, so a caller can
    hand each rank its block without building the whole tensor on every
    rank; a meta DTensor's block stays on the meta device (the dry run's)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(t, DTensor):
        names = tuple(mesh.mesh_dim_names)
        want = [Replicate()] * len(names)
        for d, axes in enumerate(dim_axes):
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(f"a DTensor shards over mesh dimensions in mesh order; "
                                 f"got axes {axes} of mesh {names}")
            for m in dims:
                want[m] = Shard(d)
        # a mesh dimension of one rank splits nothing: Shard and Replicate agree
        same = all(p == w or mesh.size(m) == 1
                   for m, (p, w) in enumerate(zip(t.placements, want)))
        if t.device_mesh != mesh or not same:
            raise ValueError(f"DTensor placements {tuple(t.placements)} on its mesh; this "
                             f"call shards as {tuple(want)} on the given mesh")
        block = t.to_local()
        for d, axes in enumerate(dim_axes):
            size = _axis(mesh, axes).size
            if t.shape[d] % size or block.shape[d] != t.shape[d] // size:
                raise ValueError(f"dimension {d} of {tuple(t.shape)} does not split evenly "
                                 f"over mesh axes {axes} ({size} shards)")
        if block.is_meta:
            device = block.device
    else:
        block = t if isinstance(t, torch.Tensor) else torch.tensor(t)
        for d, axes in enumerate(dim_axes):
            ax = _axis(mesh, axes)
            if block.shape[d] % ax.size:
                raise ValueError(f"dimension {d} of {tuple(block.shape)} is not a multiple of "
                                 f"mesh axes {axes} size {ax.size}")
            per = block.shape[d] // ax.size
            block = block.narrow(d, ax.index * per, per)
    dtype = torch.bfloat16 if block.dtype == torch.bfloat16 else torch.float32
    return block.to(device=device, dtype=dtype).contiguous()


# ---------------------------------------------------------------------------
# The partition greedies
# ---------------------------------------------------------------------------

def _winner(lbg, lbi, col_off: int, cax: _Axis):
    """(gbest, winner) of the shards' local bests: the largest gain, then
    the lowest global id among the shards that hold it."""
    gbest = pmax(lbg, cax)
    cand = torch.where(lbg >= gbest, lbi + col_off, _INT_MAX)
    return gbest, pmin(cand, cax)


def _mine(winner, col_off: int, V_loc: int):
    """(is_mine, wl): whether this shard owns ``winner``, and its local
    column (clipped into range elsewhere)."""
    is_mine = (winner >= col_off) & (winner < col_off + V_loc)
    return is_mine, (winner - col_off).clamp(0, V_loc - 1)


def _partition_greedy(block, budget: int, row: _Axis, col: _Axis, sweep: Callable,
                      sample: Callable | None, stop_if_zero: bool):
    """The partition greedy's loop.  ``sweep(curmax, cand)`` is the local
    partial gains of the candidates ``cand`` (None: every local column),
    summed over the rows by a ``psum`` over ``row``; ``sample(i,
    selected)`` draws a step's local candidates (None: sweep them all)."""
    U_loc, V_loc = block.shape
    dev = block.device
    col_off = col.index * V_loc
    # fp32 over a bf16 block too: each value is a widened element of the block
    curmax = torch.zeros((U_loc,), dtype=torch.float32, device=dev)
    selected = torch.zeros((V_loc,), dtype=torch.bool, device=dev)
    order = torch.full((budget,), -1, dtype=torch.int32, device=dev)
    gains = torch.zeros((budget,), dtype=torch.float32, device=dev)
    done = torch.zeros((1,), dtype=torch.bool, device=dev)
    for i in range(budget):
        cand = None if sample is None else sample(i, selected)
        g = psum(sweep(curmax, cand), row)
        g = torch.where(selected if cand is None else selected[cand], NEG_INF, g)
        bi = torch.argmax(g, dim=0, keepdim=True)
        lbi = bi if cand is None else cand[bi]
        gbest, winner = _winner(g[bi], lbi, col_off, col)
        stop = done | (gbest <= 0.0) if stop_if_zero else done
        take = ~stop
        is_mine, wl = _mine(winner, col_off, V_loc)
        column = psum(torch.where(is_mine, block.index_select(1, wl)[:, 0].float(), 0.0), col)
        curmax = torch.where(take, torch.maximum(curmax, column), curmax)
        selected.scatter_(0, wl, selected.gather(0, wl) | (take & is_mine))
        order[i : i + 1] = torch.where(take, winner.to(torch.int32), -1)
        gains[i : i + 1] = torch.where(take, gbest, 0.0)
        done = stop
    return order, gains


def distributed_fl_greedy(sim, budget: int, mesh, row_axes: Sequence[str] | None = ("model",),
                          col_axes: Sequence[str] = ("data",), stop_if_zero: bool = True):
    """Facility-Location greedy over a 2-D sharded similarity kernel.

    ``sim`` is the global (U, V) kernel (or a ``DTensor`` so sharded), fp32
    or bf16 (a bf16 block stays bf16 and the sweep widens it; curmax and
    every collective are fp32); rows shard over ``row_axes`` (replicated
    when None), columns over ``col_axes``.  Each step sweeps the rank's block through ``ops.fl_gains``
    (the CUDA kernel on the card, its plain version on the CPU), sums the
    row blocks with a ``psum`` and elects the winner.  Returns (order,
    gains): (budget,) global ids and gains, the same on every rank."""
    from repro_torch.kernels import ops

    row_axes = tuple(row_axes) if row_axes else ()
    row, col = _axis(mesh, row_axes), _axis(mesh, col_axes)
    block = _local_block(sim, mesh, (row_axes, tuple(col_axes)), _info(mesh).device)
    return _partition_greedy(block, budget, row, col, lambda cm, _: ops.fl_gains(block, cm),
                             None, stop_if_zero)


def distributed_stochastic_fl_greedy(sim, budget: int, mesh, key, sample_per_shard: int = 1024,
                                     row_axes: Sequence[str] | None = ("model",),
                                     col_axes: Sequence[str] = ("data",)):
    """Stochastic-greedy variant of the partition greedy.

    Each round every column shard samples ``sample_per_shard`` of its
    unselected candidates: the uniforms of ``fold_in(fold_in(key, i),
    col_idx)``, ``jax.random``'s bit for bit (``key`` from
    ``_threefry.prng_key(seed)``), their top k in ``jax.lax.top_k``'s order.
    The same sample within a column group keeps the row-wise partial gains
    summable, and the sweep (``ops.fl_gains_at``) reads only those
    columns."""
    from repro_torch.kernels import ops

    row_axes = tuple(row_axes) if row_axes else ()
    row, col = _axis(mesh, row_axes), _axis(mesh, col_axes)
    block = _local_block(sim, mesh, (row_axes, tuple(col_axes)), _info(mesh).device)
    V_loc = block.shape[1]
    s = min(sample_per_shard, V_loc)
    rev_iota = 0xFFFFFFFF - torch.arange(V_loc, dtype=torch.int64, device=block.device)
    # the draws do not depend on the picks: a block of steps' at a time
    steps = _step_keys(key, V_loc, budget, rev_iota, fold=col.index)

    def sample(i, selected):
        return _sample_unselected(next(steps), selected, rev_iota, s)

    return _partition_greedy(block, budget, row, col,
                             lambda cm, cand: ops.fl_gains_at(block, cm, cand), sample, False)


def distributed_flqmi_greedy(sim_qv, modular, budget: int, mesh,
                             col_axes: Sequence[str] = ("data",), eta: float = 1.0):
    """FLQMI targeted selection with the (|Q|, V) query kernel replicated
    over rows (|Q| small) and the ground set column-sharded.  ``modular``
    is the (V,) term, already scaled by eta (``eta`` is unused, as in the
    JAX package)."""
    from repro_torch.kernels import ops

    col_axes = tuple(col_axes)
    col = _axis(mesh, col_axes)
    dev = _info(mesh).device
    block = _local_block(sim_qv, mesh, ((), col_axes), dev)
    mod = _local_block(modular, mesh, (col_axes,), dev)
    return _partition_greedy(block, budget, _axis(mesh, ()), col,
                             lambda cm, _: ops.fl_gains(block, cm) + mod, None, False)


# ---------------------------------------------------------------------------
# ShardRule: one family's decomposition over the candidate axis
# ---------------------------------------------------------------------------
#
# A rule describes how one family's tensors and greedy state decompose over
# the candidate axis, so one engine serves every family.  Per member:
#
#   parts  = the family's tensors, the candidate axis sliced to V_loc
#   state  = the memoized statistic; replicated (FL curmax, FB acc) or
#            itself candidate-sharded (GC selsum)
#   sweep  = local marginal gains of the V_loc resident candidates
#   apply  = fold the elected winner into the state; at most one O(stat)
#            psum broadcast (the winner's column / row)


class ShardRule:
    """Family adapter for the sharded engines.

    ``part_dims()`` names each part's candidate dimension (None when the
    part is replicated); a part's batch dimension is the member's place in
    the wave.  A rule whose ``local_fn`` builds a candidate-sliced instance
    of the family sweeps through that instance's backend (the CUDA sweeps
    per shard) and keeps its state type; the others sweep themselves.
    """

    def global_parts(self, fn) -> tuple:
        """Tensors of one member, in a fixed order."""
        raise NotImplementedError

    def part_dims(self) -> tuple:
        """The candidate dimension of each part, None when replicated."""
        raise NotImplementedError

    def local_fn(self, parts):
        """A candidate-sliced instance of the family, or None."""
        return None

    def init_state(self, parts):
        """Greedy state for A = {} from the local parts."""
        return self.local_fn(parts).init_state()

    def local_sweep(self, parts, state) -> torch.Tensor:
        """Marginal gains of the V_loc local candidates (rules without a
        ``local_fn``)."""
        raise NotImplementedError

    def local_sweep_at(self, parts, state, idx) -> torch.Tensor:
        """Gains of the local candidates ``idx`` only; the default gathers
        from a full local sweep."""
        return self.local_sweep(parts, state)[idx]

    def winner_part(self, parts, state, is_mine, wl) -> torch.Tensor | None:
        """This shard's share of the winner's broadcast: its row / column
        where the shard owns the winner (local id ``wl``), exact zeros
        elsewhere; None when the update needs no collective."""
        return None

    def apply_winner(self, parts, state, shared, wl, winner):
        """The state after adding the elected global id ``winner``;
        ``shared`` is the ``psum`` of the shards' :meth:`winner_part`.  The
        engine keeps the old state where the step takes nothing."""
        raise NotImplementedError


def _col(t: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return t.index_select(1, j)[:, 0]


def _row(t: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, j)[0]


def _owned(is_mine, x: torch.Tensor) -> torch.Tensor:
    return torch.where(is_mine, x, 0.0)


@dataclasses.dataclass(frozen=True)
class FLShardRule(ShardRule):
    """FacilityLocation: columns sharded, rows (the represented set)
    replicated; curmax replicated and updated by a psum broadcast of the
    winner's column, the payload of :func:`distributed_fl_greedy`.  A wave
    of local members sweeps in one ``fl_gains`` / ``fl_gains_at`` launch."""

    use_kernel: bool = False

    def global_parts(self, fn):
        return (fn.sim,)

    def part_dims(self):
        return (1,)

    def local_fn(self, parts):
        from repro_torch.core.functions.facility_location import FacilityLocation

        (sim,) = parts
        return FacilityLocation(sim=sim, n=int(sim.shape[1]), use_kernel=self.use_kernel)

    def winner_part(self, parts, state, is_mine, wl):
        return _owned(is_mine, _col(parts[0], wl))

    def apply_winner(self, parts, state, shared, wl, winner):
        return dataclasses.replace(state, curmax=torch.maximum(state.curmax, shared))


@dataclasses.dataclass(frozen=True)
class GCShardRule(ShardRule):
    """GraphCut: ground-kernel ROWS are the candidate axis (each shard keeps
    its candidates' full rows), so selsum shards with the candidates and the
    winner's update needs no collective.  The sweep is the memoized form
    ``total - lam (2 selsum + diag)``; the stateless CUDA sweep sums in
    another order, so a ``use_kernel=True`` GraphCut is refused on a mesh."""

    def global_parts(self, fn):
        return (fn.sim_ground, fn.total, torch.diagonal(fn.sim_ground), fn.lam)

    def part_dims(self):
        return (0, 0, 0, None)

    def init_state(self, parts):
        return torch.zeros_like(parts[1])

    def local_sweep(self, parts, selsum):
        _, total, diag, lam = parts
        return total - lam * (2.0 * selsum + diag)

    def local_sweep_at(self, parts, selsum, idx):
        _, total, diag, lam = parts
        return total[idx] - lam * (2.0 * selsum[idx] + diag[idx])

    def apply_winner(self, parts, selsum, shared, wl, winner):
        return selsum + _col(parts[0], winner)


@dataclasses.dataclass(frozen=True)
class FBShardRule(ShardRule):
    """FeatureBased: feature rows sharded over candidates, the accumulated
    feature mass replicated; the winner's feature row is psum-broadcast."""

    concave: str = "sqrt"
    use_kernel: bool = False

    def global_parts(self, fn):
        return (fn.feats, fn.w)

    def part_dims(self):
        return (0, None)

    def local_fn(self, parts):
        from repro_torch.core.functions.feature_based import FeatureBased

        feats, w = parts
        return FeatureBased(feats=feats, w=w, n=int(feats.shape[0]), concave=self.concave,
                            use_kernel=self.use_kernel)

    def winner_part(self, parts, state, is_mine, wl):
        return _owned(is_mine, _row(parts[0], wl))

    def apply_winner(self, parts, state, shared, wl, winner):
        return dataclasses.replace(state, acc=state.acc + shared)


@dataclasses.dataclass(frozen=True)
class SCShardRule(ShardRule):
    """SetCover: incidence rows sharded over candidates, the covered
    indicator replicated; the winner's incidence row is psum-broadcast."""

    use_kernel: bool = False

    def global_parts(self, fn):
        return (fn.cover, fn.w)

    def part_dims(self):
        return (0, None)

    def local_fn(self, parts):
        from repro_torch.core.functions.set_cover import SetCover

        cover, w = parts
        return SetCover(cover=cover, w=w, n=int(cover.shape[0]), use_kernel=self.use_kernel)

    def winner_part(self, parts, state, is_mine, wl):
        return _owned(is_mine, _row(parts[0], wl))

    def apply_winner(self, parts, state, shared, wl, winner):
        return dataclasses.replace(state, covered=torch.maximum(state.covered, shared))


@dataclasses.dataclass(frozen=True)
class PSCShardRule(ShardRule):
    """ProbabilisticSetCover: log-miss (and probability) rows sharded over
    candidates, the miss probabilities replicated; the winner's log-miss row
    is psum-broadcast and folded multiplicatively."""

    use_kernel: bool = False

    def global_parts(self, fn):
        return (fn.log_miss, fn.probs, fn.w)

    def part_dims(self):
        return (0, 0, None)

    def local_fn(self, parts):
        from repro_torch.core.functions.set_cover import ProbabilisticSetCover

        log_miss, probs, w = parts
        return ProbabilisticSetCover(log_miss=log_miss, probs=probs, w=w,
                                     n=int(log_miss.shape[0]), use_kernel=self.use_kernel)

    def winner_part(self, parts, state, is_mine, wl):
        return _owned(is_mine, _row(parts[0], wl))

    def apply_winner(self, parts, state, shared, wl, winner):
        return dataclasses.replace(state, miss=state.miss * torch.exp(shared))


@dataclasses.dataclass(frozen=True)
class DSumShardRule(ShardRule):
    """DisparitySum: distance ROWS are the candidate axis, selsum shards
    with the candidates, and the update needs no collective (GraphCut's
    shape)."""

    def global_parts(self, fn):
        return (fn.dist,)

    def part_dims(self):
        return (0,)

    def init_state(self, parts):
        return parts[0].new_zeros((parts[0].shape[0],))

    def local_sweep(self, parts, selsum):
        return selsum

    def local_sweep_at(self, parts, selsum, idx):
        return selsum[idx]

    def apply_winner(self, parts, selsum, shared, wl, winner):
        return selsum + _col(parts[0], winner)


@dataclasses.dataclass(frozen=True)
class DMinShardRule(ShardRule):
    """DisparityMin: ``mind`` shards with the candidate rows; f(A) and |A|
    are replicated, refreshed from a psum of the winner's ``mind`` entry."""

    def global_parts(self, fn):
        return (fn.dist,)

    def part_dims(self):
        return (0,)

    def init_state(self, parts):
        from repro_torch.core.functions.disparity import _BIG

        dist_ = parts[0]
        return (
            torch.full((dist_.shape[0],), _BIG, dtype=torch.float32, device=dist_.device),
            torch.zeros((), dtype=torch.float32, device=dist_.device),  # curmin = f(A)
            torch.zeros((), dtype=torch.int32, device=dist_.device),  # count = |A|
        )

    def local_sweep(self, parts, state):
        from repro_torch.core.functions.disparity import dmin_finish

        mind, curmin, count = state
        return dmin_finish(mind, count, curmin)

    def local_sweep_at(self, parts, state, idx):
        from repro_torch.core.functions.disparity import dmin_finish

        mind, curmin, count = state
        return dmin_finish(mind[idx], count, curmin)

    def winner_part(self, parts, state, is_mine, wl):
        return _owned(is_mine, state[0].index_select(0, wl))

    def apply_winner(self, parts, state, shared, wl, winner):
        mind, curmin, count = state
        mind_w = shared.reshape(())
        newmin = torch.where(
            count <= 0, curmin,
            torch.where(count == 1, mind_w, torch.minimum(curmin, mind_w)),
        )
        return (torch.minimum(mind, _col(parts[0], winner)), newmin, count + 1)


@dataclasses.dataclass(frozen=True)
class GCMIShardRule(ShardRule):
    """GCMI: a modular function; the query-sum vector shards with the
    candidates, the running value is replicated through a scalar psum."""

    def global_parts(self, fn):
        return (fn.qsum,)

    def part_dims(self):
        return (0,)

    def init_state(self, parts):
        return parts[0].new_zeros(())

    def local_sweep(self, parts, value):
        return parts[0]

    def local_sweep_at(self, parts, value, idx):
        return parts[0][idx]

    def winner_part(self, parts, value, is_mine, wl):
        return _owned(is_mine, parts[0].index_select(0, wl))

    def apply_winner(self, parts, value, shared, wl, winner):
        return value + shared.reshape(())


@dataclasses.dataclass(frozen=True)
class LogDetShardRule(ShardRule):
    """LogDet: the candidate Cholesky rows C and pivots d2 shard with the
    candidates (kernel rows); the winner's Cholesky row and pivot are
    psum-broadcast and every shard applies the same rank-1 update, in
    ``LogDet.update``'s row-local reduce form."""

    max_select: int = 0

    def global_parts(self, fn):
        return (fn.L, torch.diagonal(fn.L))

    def part_dims(self):
        return (0, 0)

    def init_state(self, parts):
        block, diag = parts
        return (
            block.new_zeros((block.shape[0], self.max_select)),  # C
            diag.clone(),  # d2
            torch.zeros((), dtype=torch.int32, device=block.device),  # count
        )

    def local_sweep(self, parts, state):
        from repro_torch.core.functions.log_det import _log_pivot

        return _log_pivot(state[1])

    def local_sweep_at(self, parts, state, idx):
        from repro_torch.core.functions.log_det import _log_pivot

        return _log_pivot(state[1][idx])

    def winner_part(self, parts, state, is_mine, wl):
        C, d2, _ = state
        return _owned(is_mine, torch.cat([_row(C, wl), d2.index_select(0, wl)]))

    def apply_winner(self, parts, state, shared, wl, winner):
        from repro_torch.core.functions.log_det import _EPS

        block, _ = parts
        C, d2, count = state
        cj, d2j = shared[None, : self.max_select], shared[self.max_select :]
        dj = torch.sqrt(torch.clamp(d2j, min=_EPS))
        e = (_col(block, winner) - (C * cj).sum(dim=1)) / dj
        cols = torch.arange(self.max_select, device=block.device)
        return (torch.where((cols == count)[None, :], e[:, None], C), d2 - e * e, count + 1)


class _FLInfoShardRule(ShardRule):
    """The FL information measures: query-side rows replicated, candidate
    columns sharded, ``curmax`` replicated and updated by a psum broadcast
    of the winner's column (``distributed_flqmi_greedy``'s layout,
    generalized); each rebuilds its measure on the local columns."""

    def winner_part(self, parts, state, is_mine, wl):
        return _owned(is_mine, _col(parts[0], wl))

    def apply_winner(self, parts, state, shared, wl, winner):
        return dataclasses.replace(state, curmax=torch.maximum(state.curmax, shared))


@dataclasses.dataclass(frozen=True)
class FLQMIShardRule(_FLInfoShardRule):
    def global_parts(self, fn):
        return (fn.sim_qv, fn.modular)

    def part_dims(self):
        return (1, 0)

    def local_fn(self, parts):
        from repro_torch.core.info.fl import FLQMI

        sim_qv, modular = parts
        return FLQMI(sim_qv=sim_qv, modular=modular, n=int(sim_qv.shape[1]))


@dataclasses.dataclass(frozen=True)
class FLVMIShardRule(_FLInfoShardRule):
    def global_parts(self, fn):
        return (fn.sim, fn.qmax)

    def part_dims(self):
        return (1, None)

    def local_fn(self, parts):
        from repro_torch.core.info.fl import FLVMI

        sim, qmax = parts
        return FLVMI(sim=sim, qmax=qmax, n=int(sim.shape[1]))


@dataclasses.dataclass(frozen=True)
class FLCGShardRule(_FLInfoShardRule):
    def global_parts(self, fn):
        return (fn.sim, fn.pmax)

    def part_dims(self):
        return (1, None)

    def local_fn(self, parts):
        from repro_torch.core.info.fl import FLCG

        sim, pmax_ = parts
        return FLCG(sim=sim, pmax=pmax_, n=int(sim.shape[1]))


@dataclasses.dataclass(frozen=True)
class FLCMIShardRule(_FLInfoShardRule):
    def global_parts(self, fn):
        return (fn.sim, fn.qmax, fn.pmax)

    def part_dims(self):
        return (1, None, None)

    def local_fn(self, parts):
        from repro_torch.core.info.fl import FLCMI

        sim, qmax, pmax_ = parts
        return FLCMI(sim=sim, qmax=qmax, pmax=pmax_, n=int(sim.shape[1]))


# class -> factory(fn) -> ShardRule | None, resolved along the MRO (the
# plug-in shape of backends.register_gain_backend)
_SHARD_RULES: dict[type, Callable] = {}


def register_shard_rule(cls: type, factory: Callable) -> None:
    """Plug a :class:`ShardRule` factory in for ``cls`` (and subclasses)."""
    _SHARD_RULES[cls] = factory


def shard_rule(fn) -> ShardRule:
    """The shard rule serving ``fn``'s family, or ``NotImplementedError``."""
    for klass in type(fn).__mro__:
        factory = _SHARD_RULES.get(klass)
        if factory is not None:
            rule = factory(fn)
            if rule is not None:
                return rule
    raise NotImplementedError(
        f"{type(fn).__name__} has no registered ShardRule, so it cannot be "
        "mesh-sharded; plug one in via "
        "repro_torch.core.optimizers.distributed.register_shard_rule"
    )


def _reject_kernel_on_mesh(name: str) -> None:
    raise ValueError(
        f"{name} with use_kernel=True cannot be mesh-sharded bit-identically: "
        "a sequential solve sweeps through the stateless CUDA recompute "
        "while the shard rule must use the memoized form, and their float "
        "reductions differ. Solve it on one device, or build the function "
        "with use_kernel=False."
    )


def _kernel_on(fn) -> bool:
    """``fn.use_kernel`` resolved as its sequential solve resolves it:
    against the global n and the device of the function's tensors (never
    a shard's V_loc, which could pick another sweep and other bits)."""
    from repro_torch.core.optimizers.batched import _device_of

    return kernel_enabled(fn.use_kernel, fn.n, device=_device_of(fn) or "cpu")


def _register_builtin_rules():
    from repro_torch.core.functions.disparity import DisparityMin, DisparitySum
    from repro_torch.core.functions.facility_location import FacilityLocation
    from repro_torch.core.functions.feature_based import FeatureBased
    from repro_torch.core.functions.graph_cut import GraphCut
    from repro_torch.core.functions.log_det import LogDet
    from repro_torch.core.functions.set_cover import ProbabilisticSetCover, SetCover
    from repro_torch.core.info.fl import FLCG, FLCMI, FLQMI, FLVMI
    from repro_torch.core.info.gc import GCMI

    def memoized(name, rule):
        def factory(fn):
            if _kernel_on(fn):
                _reject_kernel_on_mesh(name)
            return rule()

        return factory

    register_shard_rule(FacilityLocation, lambda fn: FLShardRule(use_kernel=_kernel_on(fn)))
    register_shard_rule(GraphCut, memoized("GraphCut", GCShardRule))
    register_shard_rule(
        FeatureBased, lambda fn: FBShardRule(concave=fn.concave, use_kernel=_kernel_on(fn))
    )
    register_shard_rule(SetCover, lambda fn: SCShardRule(use_kernel=_kernel_on(fn)))
    register_shard_rule(ProbabilisticSetCover, lambda fn: PSCShardRule(use_kernel=_kernel_on(fn)))
    register_shard_rule(DisparitySum, memoized("DisparitySum", DSumShardRule))
    register_shard_rule(DisparityMin, memoized("DisparityMin", DMinShardRule))
    register_shard_rule(GCMI, lambda fn: GCMIShardRule())
    register_shard_rule(LogDet, lambda fn: LogDetShardRule(max_select=fn.max_select))
    register_shard_rule(FLQMI, lambda fn: FLQMIShardRule())
    register_shard_rule(FLVMI, lambda fn: FLVMIShardRule())
    register_shard_rule(FLCG, lambda fn: FLCGShardRule())
    register_shard_rule(FLCMI, lambda fn: FLCMIShardRule())


_register_builtin_rules()


# ---------------------------------------------------------------------------
# The sharded wave and its engines
# ---------------------------------------------------------------------------

class ShardedWave:
    """This rank's shard of a wave of B same-family functions: the members
    of its batch block, each with the candidates of its column block,
    sliced once into contiguous tensors on the mesh's device (the port's
    counterpart of the JAX package's ``stack_parts`` + ``part_specs``).

    B must be a multiple of the ``batch_axes`` size and n of the
    ``col_axes`` size; ``valid`` (B, n) masks padded candidates.  The
    caller may drop the global functions afterwards.
    """

    def __init__(self, fns: Sequence, mesh, valid=None, batch_axes: Sequence[str] = ("batch",),
                 col_axes: Sequence[str] = ("data",)):
        from repro_torch.core.optimizers.batched import _stack_leaves, member

        fns = list(fns)
        info = _info(mesh)
        self.batch_size, self.n = len(fns), fns[0].n
        self.bax, self.cax = _axis(mesh, batch_axes), _axis(mesh, col_axes)
        for ax, axes, dim, what in ((self.bax, batch_axes, self.batch_size, "batch size"),
                                    (self.cax, col_axes, self.n, "ground-set size")):
            if dim % ax.size:
                raise ValueError(f"{what} {dim} is not a multiple of mesh axis "
                                 f"{'x'.join(axes)!r} size {ax.size}")
        self.rule = shard_rule(fns[0])
        self.device = info.device
        self.b_loc, self.v_loc = self.batch_size // self.bax.size, self.n // self.cax.size
        self.b_off, self.col_off = self.bax.index * self.b_loc, self.cax.index * self.v_loc
        mine = fns[self.b_off : self.b_off + self.b_loc]
        dims = self.rule.part_dims()

        def local(t, d):
            return t if d is None else t.narrow(d, self.col_off, self.v_loc)

        per = [[local(p, d) for p, d in zip(self.rule.global_parts(f), dims)] for f in mine]
        stacked = [_stack_leaves([p[k] for p in per], self.device) for k in range(len(dims))]
        self.parts = [tuple(member(s, b) for s in stacked) for b in range(self.b_loc)]
        local_fns = [self.rule.local_fn(p) for p in self.parts]
        self.local_fns = None if local_fns[0] is None else local_fns
        valid = (torch.ones((self.batch_size, self.n), dtype=torch.bool) if valid is None
                 else torch.as_tensor(valid, dtype=torch.bool))
        if tuple(valid.shape) != (self.batch_size, self.n):
            raise ValueError(f"valid mask must be ({self.batch_size}, {self.n}), "
                             f"got {tuple(valid.shape)}")
        self.valid = valid[self.b_off : self.b_off + self.b_loc,
                           self.col_off : self.col_off + self.v_loc].to(self.device).contiguous()

    def init_states(self) -> list:
        return [self.rule.init_state(p) for p in self.parts]

    def sweep(self, states) -> torch.Tensor:
        """(B_loc, V_loc) gains of the local members' local candidates."""
        if self.local_fns is not None:
            return full_sweep_wave(self.local_fns, states)
        return torch.stack([self.rule.local_sweep(p, s) for p, s in zip(self.parts, states)])

    def sweep_at(self, states, idx: torch.Tensor) -> torch.Tensor:
        """(B_loc, k) gains of member b at its local candidates ``idx[b]``."""
        if self.local_fns is not None:
            return partial_sweep_wave(self.local_fns, states, idx)
        return torch.stack([self.rule.local_sweep_at(p, s, i)
                            for p, s, i in zip(self.parts, states, idx)])

    def apply(self, states, take, is_mine, wl, winner) -> list:
        """Every local member's state after its winner (``take`` etc. are
        (B_loc,)); the winners' broadcast is one psum for the wave."""
        rule, B = self.rule, self.b_loc
        shares = [rule.winner_part(p, s, is_mine[b : b + 1], wl[b : b + 1])
                  for b, (p, s) in enumerate(zip(self.parts, states))]
        shared = [None] * B if shares[0] is None else psum(torch.stack(shares), self.cax)
        return [
            _where_state(take[b : b + 1],
                         rule.apply_winner(p, s, shared[b], wl[b : b + 1], winner[b : b + 1]), s)
            for b, (p, s) in enumerate(zip(self.parts, states))
        ]

    def local_budgets(self, budgets) -> list[int]:
        budgets = [int(b) for b in (budgets.tolist() if torch.is_tensor(budgets) else budgets)]
        if len(budgets) != self.batch_size:
            raise ValueError(f"budget list has {len(budgets)} entries for "
                             f"{self.batch_size} instances")
        return budgets[self.b_off : self.b_off + self.b_loc]

    def gather(self, order, gains, evals, budgets: list[int]) -> GreedyResult:
        """The whole batch's result on every rank: the local members' rows
        gathered over the batch axis once."""
        B, steps = order.shape
        values = member_values(gains, budgets).to(torch.float32)
        packed = torch.cat([order.reshape(-1), gains.reshape(-1).view(torch.int32),
                            evals.to(torch.int32), values.view(torch.int32)])
        packed = _all_gather_cols(packed[None], self.bax).reshape(self.bax.size, -1)
        cut = B * steps
        return GreedyResult(
            order=packed[:, :cut].reshape(-1, steps),
            gains=packed[:, cut : 2 * cut].contiguous().view(torch.float32).reshape(-1, steps),
            n_evals=packed[:, 2 * cut : 2 * cut + B].reshape(-1),
            value=packed[:, 2 * cut + B :].contiguous().view(torch.float32).reshape(-1),
        )


def sharded_batched_greedy(wave: ShardedWave, budgets, *, max_budget: int,
                           stop_if_zero: bool = True,
                           stop_if_negative: bool = True) -> GreedyResult:
    """NaiveGreedy over a sharded wave (every rank calls it).

    Per step: the local sweep, the local first-index argmax, ``pmax`` of
    the gain and ``pmin`` of the global id over the column group, then the
    rule's update (one ``psum`` of the winners' rows where the rule needs
    it).  ``n_evals`` counts the live candidates of a step, from a ``psum``
    of ``valid``.  Returns (B, max_budget) orders and gains, (B,) ``n_evals``
    and values of the whole batch, each member bit-equal to its sequential
    ``naive_greedy``."""
    budgets = wave.local_budgets(budgets)
    dev, (B, V_loc), col_off = wave.device, wave.valid.shape, wave.col_off
    b_arr = torch.tensor(budgets, dtype=torch.int32, device=dev)[:, None]
    states = wave.init_states()
    invalid = ~wave.valid
    true_n = psum(wave.valid.sum(dim=1, keepdim=True, dtype=torch.int32), wave.cax)
    selected = torch.zeros((B, V_loc), dtype=torch.bool, device=dev)
    order = torch.full((B, max_budget), -1, dtype=torch.int32, device=dev)
    gains = torch.zeros((B, max_budget), dtype=torch.float32, device=dev)
    evals = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    done = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    for i in range(max_budget):
        g = torch.where(selected | invalid, NEG_INF, wave.sweep(states))
        lbi = torch.argmax(g, dim=1, keepdim=True)
        gbest, winner = _winner(g.gather(1, lbi), lbi, col_off, wave.cax)
        past = b_arr <= i
        stop = done | past | _should_stop(gbest, stop_if_zero, stop_if_negative)
        take = ~stop
        is_mine, wl = _mine(winner, col_off, V_loc)
        states = wave.apply(states, take[:, 0], is_mine[:, 0], wl[:, 0], winner[:, 0])
        selected.scatter_(1, wl, selected.gather(1, wl) | (take & is_mine))
        order[:, i : i + 1] = torch.where(take, winner.to(torch.int32), -1)
        gains[:, i : i + 1] = torch.where(take, gbest, 0.0)
        evals += torch.where(done | past, 0, true_n)
        done = stop
    return wave.gather(order, gains, evals[:, 0], budgets)


def sharded_batched_lazy(wave: ShardedWave, budgets, *, max_budget: int, screen_k: int = 8,
                         stop_if_zero: bool = True,
                         stop_if_negative: bool = True) -> GreedyResult:
    """The bucketed lazy greedy over a sharded wave (every rank calls it),
    the eval-sparse counterpart of :func:`sharded_batched_greedy`.

    Per step, per level of ``greedy._screen_levels``:

    1. each shard sorts its stale bounds once a step, as the one-device
       engine does (a stable ascending sort of -ub: ties by lowest id);
    2. the level's prefix of every shard's sorted (bound, id, valid) triples
       is all-gathered over the column group in flat shard order and stably
       re-sorted: shards hold ascending id ranges, so this is the global
       sort's prefix, ties in global-id order;
    3. the owning shard evaluates each screened candidate (the rule's
       gathered sweep) and a ``psum`` assembles the gains;
    4. acceptance is decided on values replicated within the column group;
       whether the next level runs is one host read of ``resolved.all()``,
       the same on every rank of that group (no collective spans the batch
       axis inside the loop, so batch groups may branch apart).

    Results are bit-identical to the sequential ``lazy_greedy`` per member:
    ids, gains, ``n_evals`` and value."""
    budgets = wave.local_budgets(budgets)
    dev, (B, V_loc), col_off, n = wave.device, wave.valid.shape, wave.col_off, wave.n
    levels = _screen_levels(n, screen_k)
    b_arr = torch.tensor(budgets, dtype=torch.int32, device=dev)
    valid = wave.valid
    rows = torch.arange(B, device=dev)
    gidx = col_off + torch.arange(V_loc, dtype=torch.int64, device=dev)
    states = wave.init_states()
    ub = wave.sweep(states).to(torch.float32)
    selected = torch.zeros((B, V_loc), dtype=torch.bool, device=dev)
    order = torch.full((B, max_budget), -1, dtype=torch.int32, device=dev)
    gains = torch.zeros((B, max_budget), dtype=torch.float32, device=dev)
    evals = psum(valid.sum(dim=1, dtype=torch.int32), wave.cax)  # the initial bound sweep
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(max_budget):
        blocked = selected | ~valid
        ubm = torch.where(blocked, NEG_INF, ub)
        neg_lv, li = torch.sort(-ubm, dim=1, stable=True)
        # (bound, id, valid) in the local sort order, exact in fp64
        local = torch.stack([neg_lv.double(), gidx[li].double(), valid.gather(1, li).double()], 1)
        resolved = torch.zeros((B,), dtype=torch.bool, device=dev)
        best_g = torch.full((B,), NEG_INF, dtype=torch.float32, device=dev)
        best_j = torch.zeros((B,), dtype=torch.int64, device=dev)
        # one slot past the end takes the writes of candidates owned elsewhere
        geval = torch.full((B, V_loc + 1), NEG_INF, dtype=torch.float32, device=dev)
        evaluated = torch.zeros((B, V_loc + 1), dtype=torch.bool, device=dev)
        cost = torch.zeros((B,), dtype=torch.int32, device=dev)
        for lo, hi in levels:
            if lo > 0 and bool(resolved.all()):
                break
            merged = _all_gather_cols(local[:, :, : min(hi + 1, V_loc)], wave.cax)
            neg_sv, mi = torch.sort(merged[:, 0], dim=1, stable=True)
            sv = (-neg_sv).to(torch.float32)  # == the global stale-bound sort through hi
            idx = merged[:, 1].gather(1, mi[:, lo:hi]).to(torch.int64)
            own, lread = _mine(idx, col_off, V_loc)
            g_loc = wave.sweep_at(states, lread).to(torch.float32)
            g_loc = torch.where(torch.gather(blocked, 1, lread), NEG_INF, g_loc)
            g = psum(torch.where(own, g_loc, 0.0), wave.cax)
            live = ~resolved
            lwrite = torch.where(own, lread, V_loc)
            geval = torch.where(live[:, None], geval.scatter(1, lwrite, g), geval)
            evaluated = torch.where(live[:, None], evaluated.scatter(1, lwrite, True), evaluated)
            # logical evaluations only: the live candidates of the level
            w_valid = merged[:, 2].gather(1, mi[:, lo:hi]).sum(dim=1).to(torch.int32)
            cost = cost + torch.where(live, w_valid, 0)
            # running first-index argmax over everything evaluated so far
            lvl_best = g.amax(dim=1)
            lvl_j = torch.where(g == lvl_best[:, None], idx, _INT_MAX).amin(dim=1)
            better = lvl_best > best_g
            tie = (lvl_best == best_g) & (lvl_j < best_j)
            best_j = torch.where(live & (better | tie), lvl_j, best_j)
            best_g = torch.where(live & better, lvl_best, best_g)
            rest = sv[:, hi] if hi < n else torch.full((B,), NEG_INF, device=dev)
            resolved = resolved | (best_g >= rest - 1e-6)
        past = i >= b_arr
        stop = done | past | _should_stop(best_g, stop_if_zero, stop_if_negative)
        take = ~stop
        is_mine, wl = _mine(best_j, col_off, V_loc)
        states = wave.apply(states, take, is_mine, wl, best_j)
        selected[rows, wl] |= take & is_mine
        ub = torch.where(evaluated[:, :V_loc], geval[:, :V_loc], ubm)
        order[:, i] = torch.where(take, best_j.to(torch.int32), -1)
        gains[:, i] = torch.where(take, best_g, 0.0)
        evals += torch.where(done | past, 0, cost)
        done = stop
    return wave.gather(order, gains, evals, budgets)
