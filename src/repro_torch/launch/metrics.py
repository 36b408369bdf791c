"""Structured serving metrics: bounded counters and histograms.

The serving front door (`launch/serve.py` / `launch/async_serve.py`) used to
keep an unbounded ``wave_seconds`` list — linear memory in flush count on a
long-lived server — and reported nothing a scheduler could train on.  This
module is the replacement: every aggregate is **bounded** (count / sum / min
/ max plus a fixed-size uniform reservoir for percentiles), and the whole
tree snapshots to one JSON-able dict consumed by the serve CLI and
``chip_smoke.py``'s served phase.  It is the JAX package's
``launch/metrics.py``: the reservoirs are seeded as there, so the same
events give the same snapshot.

Schema (``ServerMetrics.snapshot()``)::

    {
      "counters": {
        "requests": int,        # real requests served
        "waves": int,           # engine dispatches
        "slots": int,           # engine slots incl. batch pads
        "padded_slots": int,    # batch-pad slots (a mesh's batch axis)
        "rejections": int,      # submits refused by backpressure
        "flush_errors": int,    # dispatch errors (FlushError raised)
        "requeued": int,        # requests re-enqueued after a flush error
        "deadline_misses": int, # responses delivered past their deadline_s
        "sessions_opened": int, # SelectionSessions opened on this server
        "sessions_closed": int, # SelectionSessions closed
        "session_deltas": int,  # extend() deltas absorbed across sessions
        "session_churn": int,   # total selection churn across all deltas
        "retries_total": int,   # wave re-dispatch attempts scheduled
        "fallbacks_total": int, # waves an open mesh breaker served on one
                                #   device (an open kernel breaker refuses)
        "quarantined_total": int, # requests failed typed after N attempts
      },
      "queue_s":  {count, sum, max, p50, p99},   # submit -> dispatch start
      "wave_s":   {count, sum, max, p50, p99},   # one engine dispatch
      "queue_depth": {count, sum, max, p50, p99},# depth sampled at enqueue
      "delta_s":  {count, sum, max, p50, p99},   # session extend -> update
      "breakers": {"<label>": "closed|open|half_open", ...},
      "groups": {                                 # per-(family, n-bucket,
        "<label>": {                              #  optimizer) queue
          "requests": int, "waves": int,
          "queue_s": {...}, "wave_s": {...},
        }, ...
      },
    }

Group labels are ``Family/n<bucket>/<Optimizer>`` — the same (family,
n-bucket) keys the coalescer groups waves by, promoted to queue identity.

Thread-safety: increments and histogram records are guarded by one internal
lock, so the flush thread, submitters, and a metrics scraper can interleave
freely; ``snapshot()`` returns a detached copy.
"""
from __future__ import annotations

import math
import random
import threading
import zlib


def _seed_for(name: str) -> int:
    """Per-histogram reservoir seed.  Seeding every reservoir identically
    would correlate their eviction patterns (all reservoirs replace the same
    slots on the same ticks for equal-length streams); hashing the metric
    name decorrelates them while staying reproducible across runs."""
    return zlib.crc32(name.encode("utf-8"))

__all__ = ["Reservoir", "Histogram", "ServerMetrics"]


class Reservoir:
    """Fixed-size uniform sample of a stream (Vitter's algorithm R).

    Memory is O(capacity) no matter how many values are recorded; the
    percentile estimates converge on the stream's true quantiles.  The RNG
    is seeded per instance, so a server's metrics are reproducible for a
    deterministic workload.
    """

    def __init__(self, capacity: int = 512, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._rng = random.Random(seed)
        self._sample: list[float] = []
        self._seen = 0

    def add(self, value: float) -> None:
        self._seen += 1
        if len(self._sample) < self.capacity:
            self._sample.append(float(value))
            return
        j = self._rng.randrange(self._seen)
        if j < self.capacity:
            self._sample[j] = float(value)

    @property
    def seen(self) -> int:
        return self._seen

    def percentile(self, q: float) -> float:
        """Empirical q-quantile (q in [0, 1]) of the retained sample; NaN
        when nothing was recorded."""
        if not self._sample:
            return float("nan")
        s = sorted(self._sample)
        idx = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
        return s[idx]


class Histogram:
    """Bounded aggregation of a stream: count / sum / min / max exactly,
    percentiles from a fixed-size :class:`Reservoir`."""

    def __init__(self, reservoir_size: int = 512, seed: int = 0):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._reservoir = Reservoir(reservoir_size, seed=seed)

    def record(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self._reservoir.add(value)

    def percentile(self, q: float) -> float:
        return self._reservoir.percentile(q)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def snapshot(self, ndigits: int = 6) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0, "max": 0.0, "p50": 0.0, "p99": 0.0}
        return {
            "count": self.count,
            "sum": round(self.total, ndigits),
            "max": round(self.max, ndigits),
            "p50": round(self.percentile(0.50), ndigits),
            "p99": round(self.percentile(0.99), ndigits),
        }


_COUNTERS = (
    "requests",
    "waves",
    "slots",
    "padded_slots",
    "rejections",
    "flush_errors",
    "requeued",
    "deadline_misses",
    "sessions_opened",
    "sessions_closed",
    "session_deltas",
    "session_churn",
    "retries_total",
    "fallbacks_total",
    "quarantined_total",
)


class _GroupMetrics:
    """Per-(family, n-bucket, optimizer) queue accounting."""

    __slots__ = ("requests", "waves", "queue_s", "wave_s")

    def __init__(self, reservoir_size: int, label: str = ""):
        self.requests = 0
        self.waves = 0
        self.queue_s = Histogram(reservoir_size, seed=_seed_for(f"{label}/queue_s"))
        self.wave_s = Histogram(reservoir_size, seed=_seed_for(f"{label}/wave_s"))


class ServerMetrics:
    """The serving stack's metric tree (see module docstring for schema)."""

    _GUARDED_BY = {
        "counters": "_lock",
        "queue_s": "_lock",
        "wave_s": "_lock",
        "queue_depth": "_lock",
        "delta_s": "_lock",
        "groups": "_lock",
        "breaker_states": "_lock",
    }

    def __init__(self, reservoir_size: int = 512):
        self._reservoir_size = int(reservoir_size)
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {name: 0 for name in _COUNTERS}
        self.queue_s = Histogram(reservoir_size, seed=_seed_for("queue_s"))
        self.wave_s = Histogram(reservoir_size, seed=_seed_for("wave_s"))
        self.queue_depth = Histogram(reservoir_size, seed=_seed_for("queue_depth"))
        self.delta_s = Histogram(reservoir_size, seed=_seed_for("delta_s"))
        self.groups: dict[str, _GroupMetrics] = {}
        self.breaker_states: dict[str, str] = {}

    # -- recording -----------------------------------------------------------

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def _group_locked(self, label: str) -> _GroupMetrics:
        g = self.groups.get(label)
        if g is None:
            g = self.groups[label] = _GroupMetrics(self._reservoir_size, label)
        return g

    def set_breaker(self, label: str, state: str) -> None:
        """Record a circuit breaker's current state (the server binds this
        to its :class:`~repro_torch.launch.resilience.BreakerBoard`)."""
        with self._lock:
            self.breaker_states[label] = str(state)

    def observe_enqueue(self, label: str, depth: int) -> None:
        """One request admitted to ``label``'s queue, which now holds
        ``depth`` requests (the depth histogram is a scheduler's
        batching-pressure signal)."""
        with self._lock:
            self.queue_depth.record(depth)
            self._group_locked(label)  # the group exists from first admission

    def observe_wave(
        self,
        label: str,
        wave_s: float,
        *,
        requests: int,
        slots: int,
        padded_slots: int,
    ) -> None:
        """One engine dispatch for ``label``'s group."""
        with self._lock:
            self.counters["waves"] += 1
            self.counters["requests"] += requests
            self.counters["slots"] += slots
            self.counters["padded_slots"] += padded_slots
            self.wave_s.record(wave_s)
            g = self._group_locked(label)
            g.waves += 1
            g.requests += requests
            g.wave_s.record(wave_s)

    def observe_served(
        self, label: str, queue_s: float, *, deadline_missed: bool = False
    ) -> None:
        """One request answered: it waited ``queue_s`` before its wave's
        dispatch began."""
        with self._lock:
            self.queue_s.record(queue_s)
            self._group_locked(label).queue_s.record(queue_s)
            if deadline_missed:
                self.counters["deadline_misses"] += 1

    def observe_delta(self, delta_s: float, *, churn: int = 0) -> None:
        """One session ``extend()`` absorbed: it took ``delta_s`` seconds
        submit-to-update and replaced ``churn`` members of the previous
        selection (symmetric difference of the id sets)."""
        with self._lock:
            self.counters["session_deltas"] += 1
            self.counters["session_churn"] += int(churn)
            self.delta_s.record(delta_s)

    # -- reading -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Detached JSON-able copy of every counter and histogram."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "queue_s": self.queue_s.snapshot(),
                "wave_s": self.wave_s.snapshot(),
                "queue_depth": self.queue_depth.snapshot(ndigits=1),
                "delta_s": self.delta_s.snapshot(),
                "breakers": dict(sorted(self.breaker_states.items())),
                "groups": {
                    label: {
                        "requests": g.requests,
                        "waves": g.waves,
                        "queue_s": g.queue_s.snapshot(),
                        "wave_s": g.wave_s.snapshot(),
                    }
                    for label, g in sorted(self.groups.items())
                },
            }
