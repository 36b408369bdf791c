"""Set-function protocol.

Every submodular function in the port is a frozen dataclass holding tensors
and exposing a *functional, memoized* interface, vectorized over the whole
candidate set:

  state  = fn.init_state()          # pre-computed statistics for A = {}
  gains  = fn.gains(state)          # (n,) marginal gains f(j | A) for ALL j
  gains  = fn.gains_at(state, idx)  # (k,) gains for a gathered subset
  state  = fn.update(state, j)      # A <- A + {j}, O(stat) incremental
  value  = fn.evaluate(mask)        # f(A) from scratch (oracle, for tests)
  value  = fn.evaluate_state(state) # f(A) from the memoized statistics

States are frozen dataclasses too: ``update`` returns a new state and never
writes into the old one, so an optimizer can keep or drop either.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.common import NEG_INF, mask_from_indices


def _mask_negative_idxs(method):
    """Make ``gains_at`` NEG_INF on negative indices instead of wrapping.

    Every dense implementation is a plain gather, so idx = -1 silently reads
    the LAST column — an engine passing an unfiltered ``order`` buffer (-1
    padded) would treat a ghost of the last candidate as selectable.  The
    wrapper clamps negatives before the implementation runs and masks them
    to NEG_INF after, leaving idx >= 0 results bit-identical.
    """
    if getattr(method, "_neg_masked", False):
        return method

    @functools.wraps(method)
    def wrapped(self, state, idxs):
        idxs = torch.as_tensor(idxs, dtype=torch.long)
        g = method(self, state, torch.clamp(idxs, min=0))
        return torch.where(idxs.to(g.device) < 0, NEG_INF, g)

    wrapped._neg_masked = True
    return wrapped


class SetFunction:
    """Duck-typed base; concrete functions are frozen dataclasses."""

    n: int  # ground-set size
    # True where gains_at's value at an index does not depend on the other
    # indices gathered with it, bit for bit (tests/test_torch_streaming.py
    # checks every family that says so).  The streaming optimizers sweep
    # windows of arrivals at once only then, else one arrival at a time.
    local_gathers = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # families override gains_at with gather-shaped implementations; wrap
        # each override (and, below, the base default) exactly once so the
        # negative-index contract holds for every family
        impl = cls.__dict__.get("gains_at")
        if impl is not None:
            cls.gains_at = _mask_negative_idxs(impl)

    # -- interface -----------------------------------------------------------
    def init_state(self):
        raise NotImplementedError

    def gains(self, state) -> torch.Tensor:
        """Marginal gains f(j|A) for every ground element j, shape (n,)."""
        raise NotImplementedError

    def gains_at(self, state, idxs) -> torch.Tensor:
        """Gains for a subset of candidates (default: gather from full sweep).

        Functions with gather-friendly statistics override this with an
        O(k * stat) implementation used by the lazy optimizer.
        """
        g = self.gains(state)
        return g[idxs.to(g.device)]

    def gain_backend(self):
        """Advertise a fused sweep backend (see optimizers/backends.py):
        an object with ``full_sweep(fn, state)`` (and optionally
        ``partial_sweep``), or None for the plain ``gains()`` torch path."""
        return None

    def update(self, state, j):
        raise NotImplementedError

    def evaluate(self, mask) -> torch.Tensor:
        """f(A) from scratch. ``mask`` is an (n,) bool membership vector."""
        raise NotImplementedError

    def evaluate_state(self, state) -> torch.Tensor:
        raise NotImplementedError

    # -- helpers -------------------------------------------------------------
    def evaluate_indices(self, idxs) -> torch.Tensor:
        return self.evaluate(mask_from_indices(idxs, self.n))

    def marginal_gain(self, mask, j) -> torch.Tensor:
        """Oracle marginal gain f(A + j) - f(A); used by property tests."""
        mask = torch.as_tensor(mask, dtype=torch.bool)
        with_j = mask.clone()
        with_j[j] = True
        return self.evaluate(with_j) - self.evaluate(mask)


# the default gather honors the same negative-index contract as overrides
SetFunction.gains_at = _mask_negative_idxs(SetFunction.gains_at)
