"""Matrix-free facility-location gain sweeps: the CUDA kernel's launchers and
their plain versions.

``gains_c = sum_i max(metric(x_i, y_c) - curmax_i, 0)`` for every candidate
row of ``y`` (``flmf_gains``, the port of
``repro/kernels/flmf_gains.py::flmf_gains_pallas``) or for the candidates
``idx`` (``flmf_gains_at``, the port of ``flmf_gains_at_pallas``; slots with
idx < 0 return NEG_INF), without writing the (u, n) similarity.  Cosine
rows arrive pre-normalised; ``xx`` / ``yy`` are the rows' sums of squares.

The kernel (``csrc/flmf_gains.cu``, on the pipelined mainloop of
``csrc/sgemm_pipe.cuh``) sums each column in a fixed order that depends on
u alone, so its gathered sweep equals its full sweep bit for bit at the
same index.  Its launcher copies rows 16 bytes at a time where every row is
16-byte aligned, else element by element, with the same bits.  The plain
versions below stream the similarity in fixed-width tiles (:func:`~repro_torch.kernels.similarity_kernel.similarity_tiles`,
the tiles of ``FeatureSource``'s torch path) and add with ``sum``; one tile
shape keeps each column's value independent of its position, so the same
holds for them.  Kernel and plain version round differently (an fmaf chain
against a matmul) and agree to a tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.common import NEG_INF
from repro_torch.kernels import _build
from repro_torch.kernels.similarity_kernel import (
    _METRIC_CODE,
    inv_two_sigma_sq,
    similarity_tiles,
)

TILE_ROWS = 128  # the kernels' block: one partial sum per block and column
# Cap on the kernels' (blocks, columns) fp32 partial-sum scratch.  Past it a
# sweep runs in column slices that reuse one scratch; a column's sum does not
# depend on the slice it lands in.
SCRATCH_BYTES = 1 << 26


def column_slice(nblocks: int) -> int:
    """Columns per launch for a reduction over ``nblocks`` blocks of 128:
    the most that keep the scratch within :data:`SCRATCH_BYTES` (a multiple
    of 128, at least 128)."""
    cols = SCRATCH_BYTES // (4 * nblocks) // TILE_ROWS * TILE_ROWS
    return max(cols, TILE_ROWS)


def flmf_gains_plain(
    x: torch.Tensor, y: torch.Tensor, xx: torch.Tensor, yy: torch.Tensor,
    curmax: torch.Tensor, metric: str = "dot", rbf_sigma: float | None = None,
) -> torch.Tensor:
    """x (u, d), y (n, d), xx (u,), yy (n,), curmax (u,) -> gains (n,) fp32,
    in plain PyTorch; holds one (u, TILE) similarity block at a time."""
    out = x.new_empty((y.shape[0],))
    inv2s2 = inv_two_sigma_sq(x.shape[1], rbf_sigma)
    for lo, w, s in similarity_tiles(x, xx, y, yy, metric, inv2s2):
        out[lo : lo + w] = torch.clamp(s - curmax[:, None], min=0.0).sum(dim=0)[:w]
    return out


def flmf_gains_at_plain(
    x: torch.Tensor, y: torch.Tensor, xx: torch.Tensor, yy: torch.Tensor,
    curmax: torch.Tensor, idx: torch.Tensor, metric: str = "dot",
    rbf_sigma: float | None = None,
) -> torch.Tensor:
    """Gathered sweep in plain PyTorch: idx (k,) -> gains (k,); idx < 0 ->
    NEG_INF, bit-identical to :func:`flmf_gains_plain` at the same index."""
    idx = idx.to(device=y.device, dtype=torch.long)
    safe = torch.clamp(idx, 0, y.shape[0] - 1)
    g = flmf_gains_plain(x, y[safe], xx, yy[safe], curmax, metric, rbf_sigma)
    return torch.where(idx < 0, NEG_INF, g)


def _launch(x, y, xx, yy, curmax, idx, metric, rbf_sigma) -> torch.Tensor:
    u, d = x.shape
    n = y.shape[0]
    k = n if idx is None else idx.shape[0]
    out = torch.empty((k,), dtype=torch.float32, device=x.device)
    if k == 0:
        return out
    if u == 0:  # no rows: every sum is empty
        out.zero_()
        if idx is not None:
            out.masked_fill_(idx < 0, NEG_INF)
        return out
    nblocks = -(-u // TILE_ROWS)
    cols = column_slice(nblocks)
    if idx is None and k > cols:
        # sliced through an index: the gathered sweep equals the full sweep
        idx = torch.arange(k, dtype=torch.int32, device=x.device)
    # scratch from the caching allocator: dropping it on return is safe while
    # the kernel runs, as the block is reused only by later work on this stream
    partial = torch.empty((nblocks, min(k, cols)), dtype=torch.float32, device=x.device)
    lib = _build.load()
    stream = _build.raw_stream(x)
    for lo in range(0, k, cols):
        hi = min(k, lo + cols)
        rc = lib.flmf_gains_launch(
            x.data_ptr(), y.data_ptr(), xx.data_ptr(), yy.data_ptr(), curmax.data_ptr(),
            None if idx is None else idx[lo:hi].data_ptr(), u, n, hi - lo, d,
            _METRIC_CODE[metric], inv_two_sigma_sq(d, rbf_sigma), partial.data_ptr(),
            out[lo:hi].data_ptr(), stream,
        )
        _build.check(rc, "flmf_gains kernel")
    return out


def flmf_gains_cuda(x, y, xx, yy, curmax, metric="dot", rbf_sigma=None) -> torch.Tensor:
    """Launch the full sweep on checked CUDA tensors (see ``ops.flmf_gains``)."""
    return _launch(x, y, xx, yy, curmax, None, metric, rbf_sigma)


def flmf_gains_at_cuda(x, y, xx, yy, curmax, idx, metric="dot", rbf_sigma=None) -> torch.Tensor:
    """Launch the gathered sweep; ``idx`` is a contiguous int32 CUDA tensor."""
    return _launch(x, y, xx, yy, curmax, idx, metric, rbf_sigma)
