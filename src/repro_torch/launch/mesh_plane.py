"""The control plane of serving on a mesh: rank 0 decides, the others follow.

The JAX package serves a mesh from one controller.  Under
``torch.distributed`` every rank is its own process, and a served wave's
decisions — which requests ride it, their padding, retries, backoff,
deadline reaps, breaker states, the async server's timer — read a clock
and the queues, which only one process may own.  So a mesh server has one
**leader**, rank 0, and **followers**, every other rank:

- rank 0 is the front door: ``submit`` / ``flush``, the async triggers,
  sessions, retries and breakers live there and read its clock alone;
- on another rank the same constructor gives a follower: its front-door
  calls raise :class:`FollowerError` (naming rank 0), and
  ``server.follow()`` runs the waves rank 0 sends until rank 0's
  ``close()`` sends a stop.

**One plan per dispatch attempt that runs on the mesh.**  Everything that
can refuse or fail a wave — the padder, dispatch and kernel fault
boundaries, the breakers, backend resolution, the shard-rule lookup and
the kernel-on-mesh refusal, divisibility — is decided on rank 0 *before*
the plan goes out (:meth:`MeshPlane.check`), so a retry, an isolation or a
refusal never leaves a follower inside a collective that rank 0 skipped.
Then :meth:`MeshPlane.run_wave` sends the plan: a header with
``broadcast_object_list`` over a ``gloo`` control group of its own (each
member's static fields with its tensors' shapes and dtypes, which slots
are copies of which member, budgets, ``max_budget``, the stop flags,
``valid``, the optimizer spec and the wave index), then every member
tensor with ``dist.broadcast`` from rank 0 over the mesh's device group
(NCCL on the card; gloo takes card tensors too).  Every rank then calls
``BatchedEngine(fns, valid=, mesh=).run(...)`` exactly as rank 0 does, and
gets the whole batch back.  A single-device wave sends no plan.

**Idle followers.**  A follower waits for the next header on the control
group, whose collectives give up after its timeout.  So rank 0 sends an
idle header whenever no header has gone out for a quarter of that timeout
(a thread of its own, under the plane's lock): an idle server never times
a follower out, and a dead rank 0 still ends its followers within the
timeout.  A wave's header, tensors and collectives are issued under the
same lock, from the thread that dispatches the wave (the async server's
flush thread, under its dispatch lock).

**A failure inside a wave's collectives is fatal, not retried.**  A kernel
fault on a follower or a rank that dies makes every rank's group timeout
(or its lost connection) raise; the plane is then broken and every later
call on it, on every rank, raises :class:`MeshFailed`.  Nothing here falls
back to one device: the single-device reroute of an open mesh breaker is
the server's, and every response it serves says so (``degraded``).
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import threading
import time

import torch
import torch.distributed as dist

from repro_torch.launch import faults

__all__ = ["FollowerError", "MeshFailed", "MeshPlane"]


class FollowerError(RuntimeError):
    """A front-door call on a follower: only rank 0 submits, flushes and
    opens sessions on a mesh server; a follower runs ``follow()``."""


class MeshFailed(RuntimeError):
    """The mesh's control plane or a wave's collectives failed (a rank died,
    a group timed out, a kernel failed on some rank after the plan went
    out).  Fatal: the server refuses every later call with this error."""


@dataclasses.dataclass(frozen=True)
class _Slot:
    """A member tensor's place in a plan header: it follows the header."""

    shape: tuple
    dtype: torch.dtype


def _skeleton(obj, tensors: list):
    """``obj``'s tree with every tensor replaced by a :class:`_Slot`, the
    tensors appended to ``tensors`` in the order the slots take."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return _Slot(tuple(obj.shape), obj.dtype)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _skeleton(getattr(obj, f.name), tensors)
            for f in dataclasses.fields(obj) if f.init
        })
    if isinstance(obj, (tuple, list)):
        return type(obj)(_skeleton(v, tensors) for v in obj)
    return obj


def _fill(skel, tensors):
    """The inverse of :func:`_skeleton`: ``tensors`` an iterator in slot order."""
    if isinstance(skel, _Slot):
        return next(tensors)
    if dataclasses.is_dataclass(skel) and not isinstance(skel, type):
        return dataclasses.replace(skel, **{
            f.name: _fill(getattr(skel, f.name), tensors)
            for f in dataclasses.fields(skel) if f.init
        })
    if isinstance(skel, (tuple, list)):
        return type(skel)(_fill(v, tensors) for v in skel)
    return skel


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MeshPlane:
    """The leader's or a follower's end of a mesh server's control plane.

    Every rank builds it, in the same order, after ``make_mesh`` (it makes
    one ``gloo`` process group, collectively, destroyed again when the plane
    closes: rank 0's :meth:`close`, the end of a follower's :meth:`follow`).
    ``timeout`` is the control group's (default: the mesh's groups'
    timeout); rank 0 sends an idle header every quarter of it while no wave
    goes out.  ``on_wave``, when given, is called on this rank with each
    mesh wave's whole-batch results, in wave order (checks that compare the
    ranks' results read them there).
    """

    _GUARDED_BY = {"_last_sent": "_lock"}

    def __init__(self, mesh, batch_axis: str = "batch", data_axis: str = "data",
                 timeout: datetime.timedelta | None = None, on_wave=None):
        from repro_torch.core.optimizers.distributed import _info

        info = _info(mesh)  # a TypeError naming make_mesh for any other mesh
        names = tuple(mesh.mesh_dim_names)
        for name in (batch_axis, data_axis):
            if name not in names:
                raise ValueError(f"mesh has no axis {name!r} (axes: {names})")
        sizes = dict(zip(names, mesh.mesh.shape))
        self.mesh, self.batch_axis, self.data_axis = mesh, batch_axis, data_axis
        self.b_multiple, self.n_multiple = int(sizes[batch_axis]), int(sizes[data_axis])
        self.device = info.device
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.leader = self.rank == 0
        self.timeout = timeout if timeout is not None else info.timeout
        self.heartbeat_s = self.timeout.total_seconds() / 4
        # the group over every mesh dimension is the whole world (make_mesh)
        self.data_group = info.groups[tuple(range(len(names)))]
        self.control = dist.new_group(backend="gloo", timeout=self.timeout)
        self._lock = threading.Lock()
        self._last_sent = time.monotonic()
        self._broken: BaseException | None = None
        self._closed = False
        self.on_wave = on_wave
        self.waves = 0  # mesh waves this rank ran (rank 0: plans sent)
        self.plan_bytes = 0  # member-tensor bytes broadcast (rank 0)
        self.broadcast_s = 0.0  # rank 0's wall in header + tensor broadcasts
        self.plans = collections.deque(maxlen=256)  # rank 0's latest plans, one dict each
        self._stop = threading.Event()
        self._beat = None
        if self.leader and self.world > 1:
            self._beat = threading.Thread(target=self._heartbeat, name="MeshPlane.heartbeat",
                                          daemon=True)
            self._beat.start()

    # -- liveness ------------------------------------------------------------

    def check_alive(self) -> None:
        if self._broken is not None:
            raise self._fail(self._broken) from self._broken
        if self._closed:
            raise MeshFailed(f"the mesh server on rank {self.rank} is closed")

    def _fail(self, e: BaseException) -> MeshFailed:
        """Break the plane on ``e``; the error every later call raises."""
        self._broken = e
        self._stop.set()
        return MeshFailed(
            f"the mesh's control plane failed on rank {self.rank} "
            f"({type(e).__name__}: {e}); this server refuses every later call"
        )

    def _heartbeat(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            with self._lock:
                if self._stop.is_set():
                    return
                if time.monotonic() - self._last_sent < self.heartbeat_s:
                    continue
                try:
                    self._send_header({"kind": "idle"})
                except Exception as e:  # the next call on the server raises it
                    self._fail(e)
                    return

    # -- the wire ------------------------------------------------------------

    def _send_header(self, header: dict) -> None:
        dist.broadcast_object_list([header], src=0, group=self.control)
        self._last_sent = time.monotonic()

    def _recv_header(self) -> dict:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]

    def _send_tensor(self, t: torch.Tensor) -> None:
        if t.numel():
            buf = t.detach().to(self.device).contiguous().reshape(-1).view(torch.uint8)
            dist.broadcast(buf, src=0, group=self.data_group)

    def _recv_tensor(self, slot: _Slot) -> torch.Tensor:
        out = torch.empty(slot.shape, dtype=slot.dtype, device=self.device)
        if out.numel():
            dist.broadcast(out.reshape(-1).view(torch.uint8), src=0, group=self.data_group)
        return out

    def _engine(self, fns, h: dict) -> list:
        from repro_torch.core.optimizers.batched import BatchedEngine
        from repro_torch.core.optimizers.spec import OptimizerSpec

        name, params = h["optimizer"]
        stop_zero, stop_neg = h["stops"]
        with faults.suspended():  # fault boundaries were crossed on rank 0
            engine = BatchedEngine(fns, valid=h["valid"], mesh=self.mesh,
                                   batch_axis=self.batch_axis, data_axis=self.data_axis)
            results = engine.run(h["budgets"], OptimizerSpec(name, **params),
                                 stop_if_zero=stop_zero, stop_if_negative=stop_neg,
                                 max_budget=h["max_budget"])
        self.waves += 1
        if self.on_wave is not None:
            self.on_wave(results)
        return results

    # -- rank 0 --------------------------------------------------------------

    def check(self, wave) -> None:
        """Everything that can refuse ``wave`` on the mesh, decided on rank 0
        before any plan goes out: the optimizer's mesh hook, the family's
        shard rule (and the kernel-on-mesh refusal), divisibility."""
        from repro_torch.core.optimizers.batched import wave_hook
        from repro_torch.core.optimizers.distributed import shard_rule

        self.check_alive()
        wave_hook(wave.optimizer.name, True)
        shard_rule(wave.fns[0])
        if wave.batch_size % self.b_multiple or wave.n_bucket % self.n_multiple:
            raise ValueError(
                f"wave of {wave.batch_size} x n={wave.n_bucket} does not divide over the "
                f"mesh's {self.batch_axis!r} x {self.data_axis!r} axes "
                f"({self.b_multiple} x {self.n_multiple})"
            )

    def run_wave(self, wave, index: int) -> list:
        """Send ``wave``'s plan and run it on every rank (rank 0 only); the
        whole batch's results, on the host.  Any failure from the first
        header on is fatal (:class:`MeshFailed`)."""
        if not self.leader:
            raise FollowerError(f"rank {self.rank} follows rank 0; it sends no plans")
        members, slots = [], []
        for f in wave.fns:  # batch pads are copies of slot 0: sent once
            for k, m in enumerate(members):
                if m is f:
                    slots.append(k)
                    break
            else:
                slots.append(len(members))
                members.append(f)
        tensors: list = []
        skeletons = [_skeleton(f, tensors) for f in members]
        nbytes = sum(_nbytes(t) for t in tensors)
        header = {
            "kind": "wave", "index": int(index), "members": skeletons, "slots": slots,
            "tensors": [_Slot(tuple(t.shape), t.dtype) for t in tensors],
            "valid": wave.valid, "budgets": list(wave.budgets), "max_budget": wave.max_budget,
            "optimizer": (wave.optimizer.name, dict(wave.optimizer.params)),
            "stops": (wave.stop_if_zero, wave.stop_if_negative),
        }
        with self._lock:
            self.check_alive()
            try:
                t0 = time.perf_counter()
                self._send_header(header)
                for t in tensors:
                    self._send_tensor(t)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                sent_s = time.perf_counter() - t0
                results = self._engine(wave.fns, header)
            except Exception as e:
                raise self._fail(e) from e
            self.plan_bytes += nbytes
            self.broadcast_s += sent_s
            self.plans.append({"index": int(index), "bytes": nbytes, "broadcast_s": sent_s,
                               "wave_s": time.perf_counter() - t0, "slots": len(slots),
                               "members": len(members), "tensors": len(tensors)})
        return results

    def close(self, payload=None) -> None:
        """Send the followers a stop carrying ``payload`` (rank 0; once), then
        release the control group.  Nothing is sent on a broken plane: its
        followers end by their own timeouts."""
        if not self.leader or self._closed:
            return
        self._stop.set()
        if self._beat is not None:
            self._beat.join()
        try:
            if self._broken is None:
                with self._lock:
                    try:
                        self._send_header({"kind": "stop", "payload": payload})
                    except Exception as e:
                        raise self._fail(e) from e
        finally:
            self._release()

    def _release(self) -> None:
        """Close the plane and destroy its control group (a local call)."""
        self._closed = True
        if self.control is not None:
            dist.destroy_process_group(self.control)
            self.control = None

    # -- the other ranks -----------------------------------------------------

    def follow(self):
        """Run the waves rank 0 sends until its stop; returns the stop's
        payload.  Raises :class:`MeshFailed` when the plane fails."""
        if self.leader:
            raise FollowerError("rank 0 is the mesh server's front door; it does not follow")
        self.check_alive()
        try:
            while True:
                h = self._recv_header()
                if h["kind"] == "idle":
                    continue
                if h["kind"] == "stop":
                    return h.get("payload")
                it = iter([self._recv_tensor(s) for s in h["tensors"]])
                members = [_fill(s, it) for s in h["members"]]
                self._engine([members[k] for k in h["slots"]], h)
        except Exception as e:
            raise self._fail(e) from e
        finally:
            self._release()

