"""Deterministic fault injection for the serving stack.

Chaos tooling is only worth anything if it exercises the REAL code paths:
a test that monkeypatches a private method proves the monkeypatch, not the
server.  This module instead threads explicit *fault boundaries* through
the serving stack — the same lines production requests cross — and lets a
test (or ``benchmarks/chaos_bench.py``) arm them with a seeded, addressable
:class:`FaultPlan`:

    plan = FaultPlan([FaultSpec(site="dispatch", family="FacilityLocation",
                                times=1)])
    with inject(plan):
        server.flush()        # the first FL wave dispatch raises

Boundaries (each is a host-side ``check(site, **attrs)`` call in live code):

- ``"dispatch"``       — :meth:`SelectionServer._dispatch`, before the
  engine runs (attrs: family, backend, wave_index, mesh, rids, label);
- ``"kernel"``         — :func:`repro_torch.core.optimizers.backends.
  resolve_backend`, when it resolves to a CUDA-kernel (non-torch) backend
  (attrs: family, backend);
- ``"padder"``         — :func:`repro_torch.launch.coalesce.pad_function`
  (attrs: family, n, n_to);
- ``"session-extend"`` — :meth:`SelectionSession.extend`, before the delta
  is built (attrs: session, seq, mode, family).

Determinism rules:

- A spec's ``times`` / ``after`` counters tick per *matching* check call,
  and every check site is host-side Python, so firing order depends only
  on the order of the calls.
- ``rate`` draws come from the plan's own seeded RNG — same plan + same
  workload = same faults.
- ``delay_s`` sleeps before raising (latency injection); ``error=False``
  makes the spec a pure-delay fault.

Faults raise :class:`InjectedFault` (a ``RuntimeError`` tagged with its
``site``); the resilience layer (``launch/resilience.py``) treats it like
any transient engine error, which is the point — recovery is proved against
the same retry / breaker / quarantine machinery real failures hit.

This is the JAX package's ``launch/faults.py``: backend globs match the
port's names (``"cuda-*"``), and there is no trace to skip, since the port
runs eagerly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time

__all__ = [
    "SITES",
    "InjectedFault",
    "FaultSpec",
    "FaultPlan",
    "inject",
    "suspended",
    "check",
    "active_plan",
]

SITES = ("dispatch", "kernel", "padder", "session-extend")


class InjectedFault(RuntimeError):
    """A fault raised by an armed :class:`FaultPlan` at a serving boundary.

    ``site`` names the boundary, ``attrs`` is the boundary's address dict,
    ``spec`` the :class:`FaultSpec` that fired.  The resilience layer reads
    ``site`` to attribute breaker failures (a ``"kernel"`` fault trips the
    kernel breaker, a ``"dispatch"`` fault on a mesh trips the mesh one).
    """

    def __init__(self, site: str, attrs: dict, spec: "FaultSpec | None" = None):
        super().__init__(f"injected fault at {site}: {attrs}")
        self.site = site
        self.attrs = dict(attrs)
        self.spec = spec


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One addressable fault.  ``None`` matchers are wildcards.

    - ``site``: which boundary (required; one of :data:`SITES`).
    - ``family``: SetFunction class name (``"FacilityLocation"``).
    - ``backend``: gain-backend name; a trailing ``*`` prefix-matches
      (``"cuda-*"``).
    - ``wave_index``: the server's 0-based dispatch ordinal.
    - ``session``: a session id (``session-extend`` site).
    - ``rid``: fires when this request id rides the checked boundary.
    - ``mesh``: True/False — only when the dispatch is on / off a mesh.
    - ``times``: fire at most this many times (None = unlimited).
    - ``after``: skip the first ``after`` matching calls.
    - ``rate``: probability a match fires (drawn from the plan's seeded RNG).
    - ``delay_s``: sleep before acting (latency injection).
    - ``error``: False turns the spec into a pure-delay fault (no raise).
    """

    site: str
    family: str | None = None
    backend: str | None = None
    wave_index: int | None = None
    session: str | None = None
    rid: object = None
    mesh: bool | None = None
    times: int | None = 1
    after: int = 0
    rate: float = 1.0
    delay_s: float = 0.0
    error: bool = True

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; one of {SITES}")
        if self.times is not None and int(self.times) < 1:
            raise ValueError(f"times must be >= 1 or None, got {self.times!r}")
        if int(self.after) < 0:
            raise ValueError(f"after must be >= 0, got {self.after!r}")
        if not 0.0 <= float(self.rate) <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate!r}")
        if float(self.delay_s) < 0.0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s!r}")

    def matches(self, site: str, attrs: dict) -> bool:
        if site != self.site:
            return False
        if self.family is not None and attrs.get("family") != self.family:
            return False
        if self.backend is not None:
            got = attrs.get("backend")
            if got is None:
                return False
            if self.backend.endswith("*"):
                if not str(got).startswith(self.backend[:-1]):
                    return False
            elif got != self.backend:
                return False
        if self.wave_index is not None and attrs.get("wave_index") != self.wave_index:
            return False
        if self.session is not None and attrs.get("session") != self.session:
            return False
        if self.mesh is not None and bool(attrs.get("mesh")) != self.mesh:
            return False
        if self.rid is not None and self.rid not in attrs.get("rids", ()):
            return False
        return True


class FaultPlan:
    """A seeded set of :class:`FaultSpec` — arm it with :func:`inject`.

    Thread-safe: per-spec match/fire counters and the ``rate`` RNG live
    behind one lock, so the async flush thread and client threads hit the
    same deterministic sequence a single-threaded run would (per spec).
    """

    _GUARDED_BY = {"_matched": "_lock", "_fired": "_lock", "_rng": "_lock"}

    def __init__(self, specs, seed: int = 0):
        self.specs = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs
        ]
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._matched = [0] * len(self.specs)
        self._fired = [0] * len(self.specs)
        self._lock = threading.Lock()

    def fires(self, site: str, attrs: dict) -> FaultSpec | None:
        """The first spec firing for this check call, ticking counters."""
        with self._lock:
            for i, fs in enumerate(self.specs):
                if not fs.matches(site, attrs):
                    continue
                seen = self._matched[i]
                self._matched[i] += 1
                if seen < fs.after:
                    continue
                if fs.times is not None and self._fired[i] >= fs.times:
                    continue
                if fs.rate < 1.0 and self._rng.random() >= fs.rate:
                    continue
                self._fired[i] += 1
                return fs
        return None

    def counts(self) -> list[dict]:
        """Observability: per-spec ``{site, matched, fired}`` in plan order."""
        with self._lock:
            return [
                {"site": fs.site, "matched": m, "fired": f}
                for fs, m, f in zip(self.specs, self._matched, self._fired)
            ]


_STACK: list[FaultPlan] = []
_STACK_LOCK = threading.Lock()
_SUSPENDED = threading.local()


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Arm ``plan`` for the duration of the block (plans nest; the most
    recently armed plan is consulted first)."""
    with _STACK_LOCK:
        _STACK.append(plan)
    try:
        yield plan
    finally:
        with _STACK_LOCK:
            _STACK.remove(plan)


@contextlib.contextmanager
def suspended():
    """Disable fault checks on THIS thread inside the block.  The serving
    stack uses it for bookkeeping probes (e.g. resolving a wave's primary
    backend name for breaker routing) that must not consume fault budget."""
    _SUSPENDED.depth = getattr(_SUSPENDED, "depth", 0) + 1
    try:
        yield
    finally:
        _SUSPENDED.depth -= 1


def active_plan() -> FaultPlan | None:
    """The innermost armed plan, or None."""
    with _STACK_LOCK:
        return _STACK[-1] if _STACK else None



def check(site: str, **attrs) -> None:
    """The boundary hook: no-op unless a plan is armed (and the thread is
    not suspended); otherwise consults plans innermost-first and raises
    :class:`InjectedFault` when one fires.
    """
    if not _STACK or getattr(_SUSPENDED, "depth", 0) > 0:
        return
    with _STACK_LOCK:
        plans = list(_STACK)
    for plan in reversed(plans):
        fs = plan.fires(site, attrs)
        if fs is None:
            continue
        if fs.delay_s:
            time.sleep(fs.delay_s)
        if fs.error:
            raise InjectedFault(site, attrs, spec=fs)
        return
