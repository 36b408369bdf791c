"""Retry policies, typed request failures, and circuit breakers.

This module is deliberately dependency-free (stdlib only): the
:class:`RetryPolicy` rides on :class:`~repro_torch.core.optimizers.spec.
SelectionSpec`, so ``core`` may import it without pulling the serving
stack in.  It is the JAX package's ``launch/resilience.py``; the backoff
delays equal that module's value for value.

Three pieces:

- :class:`RetryPolicy` — validated retry/backoff knobs carried per request.
  ``timeout_s`` is the request's WALL-CLOCK budget across attempts; it is
  distinct from the spec's ``deadline_s``, which only shapes *scheduling*
  (when a group flushes) and never fails a request.  Backoff jitter is
  deterministic, derived from the request id and attempt number — two runs
  of the same workload back off identically.
- :class:`RequestFailed` — the typed terminal error a request resolves to
  when it exhausts its attempts (``reason="quarantined"``), its
  ``timeout_s`` (``reason="timeout"``), or meets an open kernel breaker
  (``reason="breaker_open"``); carries the full attempt history.
- :class:`CircuitBreaker` / :class:`BreakerBoard` — per-key
  closed -> open -> half-open breakers.  The serving stack keys them by
  ``(family, "kernel")`` and charges them only for kernel faults (a
  ``"kernel"`` injected fault, a kernel that fails to build or launch).
  Where the JAX package reroutes a wave of an open kernel breaker to its
  plain sweeps, the port refuses the wave with :class:`BreakerOpen`: no
  answer is served off the kernels its sequential solve takes.  The
  ``(family, "mesh")`` breaker waits for the sharded engine (ROADMAP queue
  1, item 11).
"""
from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
from typing import Callable, Mapping

__all__ = [
    "RetryPolicy",
    "SINGLE_ATTEMPT",
    "RequestFailed",
    "CircuitBreaker",
    "BreakerBoard",
    "BreakerOpen",
]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Validated retry/backoff knobs for one request (hashable).

    - ``max_attempts``: total dispatch attempts before the request is
      quarantined with a :class:`RequestFailed` (1 = no retry).
    - ``backoff_s`` / ``backoff_mult`` / ``max_backoff_s``: exponential
      backoff schedule — attempt k waits
      ``min(backoff_s * backoff_mult**(k-1), max_backoff_s)``.
    - ``jitter``: +/- fraction applied to each backoff, drawn
      deterministically from (request id, attempt) — never from wall-clock
      RNG, so reruns are bit-reproducible.
    - ``timeout_s``: wall-clock budget from submit; a request older than
      this is failed (``reason="timeout"``) instead of retried.  Distinct
      from ``deadline_s``: a lapsed deadline flushes early and flags the
      response, a lapsed timeout fails the request.
    """

    max_attempts: int = 3
    backoff_s: float = 0.01
    backoff_mult: float = 2.0
    max_backoff_s: float = 1.0
    jitter: float = 0.1
    timeout_s: float | None = None

    def __post_init__(self):
        if int(self.max_attempts) < 1:
            raise ValueError(
                f"max_attempts must be an int >= 1, got {self.max_attempts!r}"
            )
        object.__setattr__(self, "max_attempts", int(self.max_attempts))
        for name in ("backoff_s", "max_backoff_s"):
            v = float(getattr(self, name))
            if not math.isfinite(v) or v < 0:
                raise ValueError(f"{name} must be a finite float >= 0, got {v!r}")
            object.__setattr__(self, name, v)
        mult = float(self.backoff_mult)
        if not math.isfinite(mult) or mult < 1.0:
            raise ValueError(f"backoff_mult must be >= 1, got {mult!r}")
        object.__setattr__(self, "backoff_mult", mult)
        j = float(self.jitter)
        if not 0.0 <= j <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {j!r}")
        object.__setattr__(self, "jitter", j)
        if self.timeout_s is not None:
            t = float(self.timeout_s)
            if not math.isfinite(t) or t <= 0:
                raise ValueError(
                    "timeout_s must be a positive finite number of seconds "
                    f"(or None), got {t!r}"
                )
            object.__setattr__(self, "timeout_s", t)

    def backoff(self, attempt: int, seed: object = 0) -> float:
        """Seconds to wait after failed attempt ``attempt`` (1-based), with
        deterministic jitter derived from ``seed`` (the request id)."""
        base = min(
            self.backoff_s * self.backoff_mult ** (max(1, attempt) - 1),
            self.max_backoff_s,
        )
        if base <= 0.0 or self.jitter <= 0.0:
            return base
        u = random.Random(f"{seed!r}/{attempt}").random()  # reproducible
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))

    def to_dict(self) -> dict:
        return {
            "max_attempts": self.max_attempts,
            "backoff_s": self.backoff_s,
            "backoff_mult": self.backoff_mult,
            "max_backoff_s": self.max_backoff_s,
            "jitter": self.jitter,
            "timeout_s": self.timeout_s,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "RetryPolicy":
        return cls(**{k: d[k] for k in d})


# the implicit policy of a request with no retry configured: one attempt,
# no backoff — resilient flush paths fail it typed on first error instead
# of raising a bare FlushError past the caller
SINGLE_ATTEMPT = RetryPolicy(
    max_attempts=1, backoff_s=0.0, jitter=0.0, timeout_s=None
)


class RequestFailed(RuntimeError):
    """Terminal, typed failure of one request.

    ``reason`` is ``"quarantined"`` (attempts exhausted — the request was
    isolated so it cannot re-poison its group), ``"timeout"`` (its
    ``RetryPolicy.timeout_s`` lapsed) or ``"breaker_open"`` (its wave met
    an open kernel breaker: :class:`BreakerOpen`, not retried).  ``attempts`` is the full history:
    a tuple of ``{"attempt", "error", "elapsed_s"}`` dicts.  ``__cause__``
    is the last underlying error, when there was one.
    """

    def __init__(self, rid, reason: str, attempts=(), cause=None):
        attempts = tuple(attempts)
        last = attempts[-1]["error"] if attempts else None
        super().__init__(
            f"request {rid!r} {reason} after {len(attempts)} attempt(s)"
            + (f"; last error: {last}" if last else "")
        )
        self.rid = rid
        self.reason = reason
        self.attempts = attempts
        if cause is not None:
            self.__cause__ = cause


class CircuitBreaker:
    """closed -> open -> half-open breaker over consecutive failures.

    ``threshold`` consecutive failures open the breaker; after
    ``cooldown_s`` the next ``allow()`` transitions to half-open (probe
    traffic passes).  A half-open failure re-opens (fresh cooldown); a
    success closes.  ``allow()`` is what dispatch consults — False means
    "refuse the wave" (:class:`BreakerOpen`).
    """

    _GUARDED_BY = {
        "_state": "_lock",
        "_failures": "_lock",
        "_opened_at": "_lock",
    }

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if int(threshold) < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold!r}")
        if float(cooldown_s) < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s!r}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._state = "half_open"  # probe traffic passes
                    return True
                return False
            return True  # half_open: keep probing until a record lands

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half_open":
                self._state = "open"  # failed probe: fresh cooldown
                self._opened_at = self._clock()
                return
            self._failures += 1
            if self._failures >= self.threshold and self._state == "closed":
                self._state = "open"
                self._opened_at = self._clock()

    def record_success(self) -> None:
        with self._lock:
            self._state = "closed"
            self._failures = 0


class BreakerBoard:
    """A lazily-populated map of breakers keyed by hashable keys (the
    serving stack uses ``(family, "kernel")`` / ``(family, "mesh")``).

    ``bind(listener)`` registers a ``listener(label, state)`` callback
    invoked on every state CHANGE — the server wires it to
    ``ServerMetrics.set_breaker`` so ``snapshot()["breakers"]`` mirrors the
    board.  Labels join tuple keys with ``/``.
    """

    # _listener is deliberately undeclared: bind() happens once at server
    # construction before any traffic, and firing it outside _lock is what
    # keeps listener callbacks (metrics) from running under the board lock
    _GUARDED_BY = {"_breakers": "_lock"}

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._breakers: dict = {}
        self._lock = threading.Lock()
        self._listener: Callable[[str, str], None] | None = None

    @staticmethod
    def label(key) -> str:
        if isinstance(key, tuple):
            return "/".join(str(k) for k in key)
        return str(key)

    def bind(self, listener: Callable[[str, str], None]) -> None:
        self._listener = listener

    def get(self, key) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = self._breakers[key] = CircuitBreaker(
                    self.threshold, self.cooldown_s, clock=self._clock
                )
            return br

    def _notify(self, key, before: str, breaker: CircuitBreaker) -> None:
        after = breaker.state
        if after != before and self._listener is not None:
            self._listener(self.label(key), after)

    def allow(self, key) -> bool:
        br = self.get(key)
        before = br.state
        out = br.allow()
        self._notify(key, before, br)
        return out

    def record_failure(self, key) -> None:
        br = self.get(key)
        before = br.state
        br.record_failure()
        self._notify(key, before, br)

    def record_success(self, key) -> None:
        br = self.get(key)
        before = br.state
        br.record_success()
        self._notify(key, before, br)

    def states(self) -> dict:
        """{label: state} for every breaker the board has created."""
        with self._lock:
            items = list(self._breakers.items())
        return {self.label(k): b.state for k, b in items}


class BreakerOpen(RuntimeError):
    """A wave refused because the breaker at ``key`` (``(family,
    "kernel")``) is open.  Its requests fail typed (``FlushError`` on the
    single-attempt flush, ``RequestFailed(reason="breaker_open")`` on the
    resilient one) until the cooldown lets a probe wave through."""

    def __init__(self, key):
        super().__init__(
            f"breaker {BreakerBoard.label(key)!r} is open: the {key[0]} wave is "
            "refused, not served off its kernels"
        )
        self.key = key
