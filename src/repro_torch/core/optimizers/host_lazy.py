"""Faithful Minoux accelerated-greedy (paper §5.3.2) on the host.

This is the literal priority-queue algorithm the paper's C++ engine runs,
kept as the reference implementation for the evaluation-count comparison
(the hardware-independent reproduction of Table 2).  The production path
is the bound-screened variant in greedy.py.

The heap's pops, pushes and decisions are the JAX package's, one gain
evaluation per stale pop, and ``n_evals`` counts those.  The pops between
two accepts all evaluate at one state, so where the function's gathered
sweeps are index-local (``backends.local_gathers``) the engine evaluates
the next stale pops' candidates ahead, in one gathered sweep, and the
heap reads their gains as it pops them: the same values, bit for bit, in
a few sweeps a pick instead of one read-back per pop.  Without that
contract it sweeps one candidate per pop.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core.optimizers.backends import full_sweep, local_gathers, partial_sweep
from repro_torch.core.optimizers.greedy import _device_of_state

# candidates evaluated ahead in the first sweep after an accept; each
# further sweep between two accepts doubles it, up to _AHEAD_MAX (below the
# gathered FL kernel's full-sweep crossover at n = 50,000)
_AHEAD_MIN = 8
_AHEAD_MAX = 1024


def _next_stale(heap, m: int, size: int, known: dict) -> list[int]:
    """Up to ``m`` ids of the next pops whose bounds are stale and whose
    gains are not known yet, in pop order; the heap is left as it was."""
    popped = [heapq.heappop(heap) for _ in range(min(m, len(heap)))]
    for item in popped:
        heapq.heappush(heap, item)
    return [j for _, j, fresh_at in popped if fresh_at != size and j not in known]


def host_lazy_greedy(
    fn,
    budget: int,
    stop_if_zero: bool = True,
    stop_if_negative: bool = True,
):
    """Returns (order, gains, n_evals): Python lists of the picks and their
    gains, and the number of gain evaluations (the first full sweep
    included)."""
    state = fn.init_state()
    ub = full_sweep(fn, state).cpu().numpy().astype(np.float64)
    device = _device_of_state(state)
    ahead_max = _AHEAD_MAX if local_gathers(fn) else 1
    n_evals = int(ub.shape[0])
    # max-heap of (-upper_bound, index, fresh_at_size)
    heap = [(-ub[i], i, 0) for i in range(ub.shape[0])]
    heapq.heapify(heap)
    order, gains = [], []
    known, ahead = {}, min(_AHEAD_MIN, ahead_max)  # gains at the current state
    while len(order) < budget and heap:
        neg_ub, j, fresh_at = heapq.heappop(heap)
        if fresh_at == len(order):
            g = -neg_ub  # bound is exact for the current set
        else:
            if j not in known:
                batch = [j] + _next_stale(heap, ahead - 1, len(order), known)
                idx = torch.tensor(batch, dtype=torch.int64, device=device)
                known.update(zip(batch, partial_sweep(fn, state, idx).tolist()))
                ahead = min(2 * ahead, ahead_max)
            g = known[j]
            n_evals += 1
            # push back unless it still tops the heap
            if heap and -heap[0][0] > g + 1e-12:
                heapq.heappush(heap, (-g, j, len(order)))
                continue
        if (stop_if_zero and g <= 0.0) or (stop_if_negative and g < 0.0):
            break
        state = fn.update(state, torch.tensor([j], dtype=torch.int64, device=device))
        order.append(j)
        gains.append(g)
        known, ahead = {}, min(_AHEAD_MIN, ahead_max)
    return order, gains, n_evals
