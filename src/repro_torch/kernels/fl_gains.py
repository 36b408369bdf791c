"""Facility-location gain sweeps: the CUDA kernel's launchers and their plain
versions.

``gains_j = sum_i max(S[i, j] - curmax_i, 0)`` over a materialised (u, n)
similarity, for every column (``fl_gains``, the port of
``repro/kernels/fl_gains.py::fl_gains_pallas``) or for a gathered subset
``idx`` (``fl_gains_at``, the port of ``fl_gains_at_pallas``; slots with
idx < 0 return NEG_INF).

The summation order is fixed by u alone: the rows are cut into chunks of
:data:`ROWS_PER_CHUNK`, each chunk is summed row by row, and the chunk sums
are added in chunk order.  The kernel (``csrc/fl_gains.cu``) and the plain
versions below add in exactly that order, so

- the gathered sweep equals the full sweep bit for bit at the same index,
  whichever of the two implementations runs, and
- the kernel and its plain version agree bit for bit as well.
"""
from __future__ import annotations

import torch

from repro_torch.common import NEG_INF
from repro_torch.kernels import _build

ROWS_PER_CHUNK = 128  # rows summed in order before the chunk sums are added
_MAX_GRID_Y = 65535  # CUDA's grid.y limit; the full sweep puts one chunk per grid row


def _column_sums(cols: torch.Tensor, curmax: torch.Tensor) -> torch.Tensor:
    """(u, k) columns -> (k,) sums of relu(cols - curmax) in the kernel's order."""
    u, k = cols.shape
    r_len = ROWS_PER_CHUNK
    n_full, tail = divmod(u, r_len)
    part = cols.new_zeros((n_full + (tail > 0), k))
    body = cols[: n_full * r_len].reshape(n_full, r_len, k)
    cm_body = curmax[: n_full * r_len].reshape(n_full, r_len, 1)
    for r in range(r_len):
        if n_full:
            part[:n_full] += torch.clamp(body[:, r] - cm_body[:, r], min=0.0)
        if r < tail:
            i = n_full * r_len + r
            part[n_full] += torch.clamp(cols[i] - curmax[i], min=0.0)
    out = cols.new_zeros((k,))
    for c in range(part.shape[0]):
        out += part[c]
    return out


def fl_gains_plain(sim: torch.Tensor, curmax: torch.Tensor) -> torch.Tensor:
    """sim (u, n), curmax (u,) -> gains (n,) fp32, in plain PyTorch."""
    return _column_sums(sim, curmax)


def fl_gains_at_plain(sim: torch.Tensor, curmax: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gathered sweep in plain PyTorch: idx (k,) -> gains (k,); idx < 0 -> NEG_INF."""
    idx = idx.to(device=sim.device, dtype=torch.long)
    cols = sim[:, torch.clamp(idx, 0, sim.shape[1] - 1)]
    return torch.where(idx < 0, NEG_INF, _column_sums(cols, curmax))


def _launch(sim: torch.Tensor, curmax: torch.Tensor, idx: torch.Tensor | None) -> torch.Tensor:
    u, n = sim.shape
    k = n if idx is None else idx.shape[0]
    out = torch.empty((k,), dtype=torch.float32, device=sim.device)
    if k == 0:
        return out
    if u == 0:  # no rows: every sum is empty
        out.zero_()
        if idx is not None:
            out.masked_fill_(idx < 0, NEG_INF)
        return out
    nchunks = -(-u // ROWS_PER_CHUNK)
    if nchunks > _MAX_GRID_Y:
        raise ValueError(f"fl_gains kernel takes at most {_MAX_GRID_Y * ROWS_PER_CHUNK} rows, got {u}")
    # scratch from the caching allocator: dropping it on return is safe while
    # the kernel runs, as the block is reused only by later work on this stream
    partial = torch.empty((nchunks, k), dtype=torch.float32, device=sim.device)
    lib = _build.load()
    rc = lib.fl_gains_launch(
        sim.data_ptr(), sim.stride(0), u, n, curmax.data_ptr(),
        None if idx is None else idx.data_ptr(), k, ROWS_PER_CHUNK,
        partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(sim.device).cuda_stream,
    )
    _build.check(rc, "fl_gains kernel")
    return out


def fl_gains_cuda(sim: torch.Tensor, curmax: torch.Tensor) -> torch.Tensor:
    """Launch the full sweep on checked CUDA tensors (see ``ops.fl_gains``)."""
    return _launch(sim, curmax, None)


def fl_gains_at_cuda(sim: torch.Tensor, curmax: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the gathered sweep; ``idx`` is a contiguous int32 CUDA tensor."""
    return _launch(sim, curmax, idx)
