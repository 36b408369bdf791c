"""The fixed-order row reductions of ``csrc/row_reduce.cuh``, in plain
PyTorch.

The block layout (DisparityMin's row stream, :func:`reduce_rows`): the
kernel reduces each row of an (n, n) matrix with one block of
:data:`THREADS` threads (``_build`` compiles it with this module's value):
thread t takes the elements k = t, t + THREADS, ... in increasing k, then
the partials meet in a halving tree, lane i taking lane i + h for h = 16,
8, 4, 2, 1 inside each warp of :data:`WARP` threads and then across the
warps' results.  :func:`reduce_rows` reduces in exactly that order with
elementwise operations only.

The warp layout (the coverage sweeps over an (n, F) matrix,
:func:`reduce_rows_warp`): one warp of :data:`WARP` lanes sums a row, lane
l taking the columns f = l, l + WARP, ... in increasing f, then the
in-warp halving tree.  The order depends on F alone, so

- a row's sum never depends on which or how many rows are reduced with it
  (the gathered sweeps equal the full sweeps bit for bit), and
- with the same rounding steps as the kernel's, it equals the kernel bit
  for bit.

The selected-columns warp layout (the dense pairwise sums of GraphCut and
DisparitySum, :func:`reduce_selected_warp`): the warp layout taken over
the F selected columns of an (n, n) matrix, in the order of their
ascending list: the order depends on that list alone, with the same two
consequences.  A sum has an order, so the kernel keeps this one path for
every F (a row stream would add in another order); the kernel stages the
list in chunks of :data:`SEL_CHUNK` positions, which changes no order.

The vector warp layout (the SetCover sweep, :func:`reduce_rows_warp4`):
one warp sums a row cut into chunks of :data:`CHUNK` columns, lane l
taking the chunks c = l, l + WARP, ... in increasing c and a chunk's
columns in order, then the in-warp halving tree; again an order set by F
alone.
"""
from __future__ import annotations

from typing import Callable

import torch

THREADS = 256  # the kernel's threads per row: the one source of that number
WARP = 32
CHUNK = 4  # columns per lane and 16-byte load in the vector warp layout
SEL_CHUNK = 1024  # list positions the selected-columns kernel stages per round

Step = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _halve(v: torch.Tensor, combine) -> torch.Tensor:
    """Halving tree over the last axis: slot i takes slot i + h, h halving."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = combine(v[..., :h], v[..., h:])
    return v[..., 0]


def reduce_rows(
    mat: torch.Tensor,
    m: torch.Tensor,
    step: Step,
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    init: float,
) -> torch.Tensor:
    """Reduce every row of ``mat`` (n, n) in the block layout.  ``step(acc,
    s, m)`` folds an (n, w) block ``s`` of columns, with mask values ``m``
    (w,), into the accumulators ``acc`` (n, w); ``combine`` merges two
    partials.  Holds one (n, THREADS) block of the matrix at a time."""
    n = mat.shape[1]
    acc = mat.new_full((mat.shape[0], THREADS), init)
    for lo in range(0, n, THREADS):
        w = min(THREADS, n - lo)
        acc[:, :w] = step(acc[:, :w], mat[:, lo : lo + w], m[lo : lo + w])
    return _halve(_halve(acc.reshape(-1, THREADS // WARP, WARP), combine), combine)


def reduce_rows_warp(
    mat: torch.Tensor,
    rows: torch.Tensor | None,
    term: Callable[[torch.Tensor, int, int], torch.Tensor],
) -> torch.Tensor:
    """Sum ``term`` over the rows of ``mat`` (n, F) in the warp layout: all
    rows (``rows`` None) or the rows ``rows`` (k,) int64, indices already in
    [0, n).  ``term(s, lo, hi)`` maps a (k, hi - lo) block ``s`` of the
    columns lo .. hi - 1 to the values to add.  Holds the gathered rows (for
    ``rows``) and one (k, WARP) block of terms at a time."""
    sub = mat if rows is None else mat.index_select(0, rows)
    acc = mat.new_zeros((sub.shape[0], WARP))
    for lo in range(0, mat.shape[1], WARP):
        hi = min(lo + WARP, mat.shape[1])
        acc[:, : hi - lo] = acc[:, : hi - lo] + term(sub[:, lo:hi], lo, hi)
    return _halve(acc, torch.add)


def reduce_selected_warp(
    mat: torch.Tensor, rows: torch.Tensor | None, sel: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Sum ``mat[g, sel[t]] * w[t]`` over t = 0 .. F-1 in the warp layout
    over F = len(sel), for every row g of ``mat`` (n, n) (``rows`` None) or
    the rows ``rows`` (k,) int64, indices already in [0, n); ``sel`` the
    ascending selected columns (int64), ``w`` (F,) their weights.  Holds
    about THREADS * n gathered elements at a time."""
    k = mat.shape[0] if rows is None else rows.shape[0]
    out = mat.new_empty((k,))
    step = max(1, THREADS * mat.shape[1] // max(sel.numel(), 1))
    for lo in range(0, k, step):
        hi = min(k, lo + step)
        g = torch.arange(lo, hi, device=mat.device) if rows is None else rows[lo:hi]
        out[lo:hi] = reduce_rows_warp(mat[g[:, None], sel[None, :]], None,
                                      lambda s, a, b: s * w[a:b])
    return out


def reduce_rows_warp4(
    mat: torch.Tensor, term: Callable[[torch.Tensor, slice], torch.Tensor]
) -> torch.Tensor:
    """Sum ``term`` over every row of ``mat`` (n, F) in the vector warp
    layout.  ``term(s, cols)`` maps the (n, len) block ``s = mat[:, cols]``
    of the columns ``cols`` (a slice with step :data:`CHUNK`: column e of
    the chunks of lanes 0 .. len - 1 of one round) to the values to add.
    Holds one (n, WARP) block of terms at a time."""
    n, F = mat.shape
    acc = mat.new_zeros((n, WARP))
    for lo in range(0, F, CHUNK * WARP):  # one round: a chunk for every lane
        hi = min(lo + CHUNK * WARP, F)
        for e in range(CHUNK):
            cols = slice(lo + e, hi, CHUNK)
            s = mat[:, cols]
            lanes = s.shape[1]  # the lanes whose chunk reaches column e
            if lanes:
                acc[:, :lanes] = acc[:, :lanes] + term(s, cols)
    return _halve(acc, torch.add)
