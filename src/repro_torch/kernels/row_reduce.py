"""The fixed-order row reduction of the dense pairwise sweeps
(``csrc/row_reduce.cuh``), in plain PyTorch.

The kernel reduces each row of an (n, n) matrix with one block of
:data:`THREADS` threads (``_build`` compiles it with this module's value): thread t takes the elements k = t, t + THREADS, ...
in increasing k, then the partials meet in a halving tree, lane i taking
lane i + h for h = 16, 8, 4, 2, 1 inside each warp of :data:`WARP` threads
and then across the warps' results.  :func:`reduce_rows` adds in exactly
that order with elementwise operations only, so

- its result for a row never depends on which or how many rows are reduced
  with it (the gathered sweeps equal the full sweeps bit for bit), and
- with the same rounding steps as the kernel's, it equals the kernel bit
  for bit.
"""
from __future__ import annotations

from typing import Callable

import torch

THREADS = 256  # the kernel's threads per row: the one source of that number
WARP = 32

Step = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _halve(v: torch.Tensor, combine) -> torch.Tensor:
    """Halving tree over the last axis: slot i takes slot i + h, h halving."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = combine(v[..., :h], v[..., h:])
    return v[..., 0]


def reduce_rows(
    mat: torch.Tensor,
    rows: torch.Tensor | None,
    m: torch.Tensor,
    step: Step,
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    init: float,
) -> torch.Tensor:
    """Reduce rows of ``mat`` (n, n): all of them (``rows`` None) or the
    rows ``rows`` (k,) int64, indices already in [0, n).  ``step(acc, s, m,
    cols, g)`` folds a (k, w) block ``s`` of columns ``cols`` (1, w), with
    mask values ``m`` (w,), into the accumulators ``acc`` (k, w) of rows
    ``g`` (k, 1); ``combine`` merges two partials.  Holds one (k, THREADS)
    block of the matrix at a time."""
    n = mat.shape[1]
    k = mat.shape[0] if rows is None else rows.shape[0]
    dev = mat.device
    g = (torch.arange(k, device=dev) if rows is None else rows)[:, None]
    acc = mat.new_full((k, THREADS), init)
    for lo in range(0, n, THREADS):
        w = min(THREADS, n - lo)
        s = mat[:, lo : lo + w] if rows is None else mat[rows, lo : lo + w]
        cols = torch.arange(lo, lo + w, device=dev)[None, :]
        acc[:, :w] = step(acc[:, :w], s, m[lo : lo + w], cols, g)
    return _halve(_halve(acc.reshape(k, THREADS // WARP, WARP), combine), combine)
