"""Matrix-free graph-cut gain sweeps (stateless, from the selection mask):
the CUDA kernel's launchers and their plain versions.

``gains_g = total_g - lam * (2 * sum_c metric(y_g, y_c) * m_c + diag_g)``
for every candidate g (``gcmf_gains``, the port of
``repro/kernels/gcmf_gains.py::gcmf_gains_pallas``) or for the candidates
``idx`` (``gcmf_gains_at``, the port of ``gcmf_gains_at_pallas``; slots with
idx < 0 return NEG_INF), without writing the (n, n) similarity.  ``total``
and ``diag`` arrive precomputed (GraphCutMF's memoized statistics); ``lam``
is a one-element tensor on the inputs' device, read by the kernel there.

The kernel (``csrc/gcmf_gains.cu``) computes only the selected columns (m_c
!= 0, compacted on the device by ``select_cols``) and sums each candidate's
row over them in a fixed order that depends on the mask alone, so its
gathered sweep equals its full sweep bit for bit at the same index.  The
plain versions stream the similarity of the ground rows to fixed-width
tiles of candidates (``similarity_tiles``) and add with ``sum``, which
holds the same property; kernel and plain version round differently and
agree to a tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.common import NEG_INF
from repro_torch.kernels import _build
from repro_torch.kernels.flmf_gains import TILE_ROWS, column_slice
from repro_torch.kernels.select_cols import select_cols_cuda
from repro_torch.kernels.similarity_kernel import (
    _METRIC_CODE,
    inv_two_sigma_sq,
    similarity_tiles,
)

_MAX_GRID_Y = 65535  # CUDA's grid.y limit: the kernel's candidate blocks


def _plain(yj, yyj, y, yy, selmask, total, diag, lam, metric, rbf_sigma) -> torch.Tensor:
    """Candidate rows yj (j, d) against the ground y (n, d)."""
    selsum = y.new_empty((yj.shape[0],))
    inv2s2 = inv_two_sigma_sq(y.shape[1], rbf_sigma)
    for lo, w, s in similarity_tiles(y, yy, yj, yyj, metric, inv2s2):  # s (n, TILE)
        selsum[lo : lo + w] = (s * selmask[:, None]).sum(dim=0)[:w]
    return total - lam * (2.0 * selsum + diag)


def gcmf_gains_plain(
    y: torch.Tensor, yy: torch.Tensor, selmask: torch.Tensor, total: torch.Tensor,
    diag: torch.Tensor, lam: torch.Tensor, metric: str = "dot",
    rbf_sigma: float | None = None,
) -> torch.Tensor:
    """y (n, d), yy / selmask / total / diag (n,), lam one-element -> gains
    (n,) fp32, in plain PyTorch; holds one (n, TILE) similarity block at a time."""
    return _plain(y, yy, y, yy, selmask, total, diag, lam.reshape(()), metric, rbf_sigma)


def gcmf_gains_at_plain(
    y: torch.Tensor, yy: torch.Tensor, selmask: torch.Tensor, total: torch.Tensor,
    diag: torch.Tensor, lam: torch.Tensor, idx: torch.Tensor, metric: str = "dot",
    rbf_sigma: float | None = None,
) -> torch.Tensor:
    """Gathered sweep in plain PyTorch: idx (k,) -> gains (k,); idx < 0 ->
    NEG_INF, bit-identical to :func:`gcmf_gains_plain` at the same index."""
    idx = idx.to(device=y.device, dtype=torch.long)
    safe = torch.clamp(idx, 0, y.shape[0] - 1)
    g = _plain(y[safe], yy[safe], y, yy, selmask, total[safe], diag[safe],
               lam.reshape(()), metric, rbf_sigma)
    return torch.where(idx < 0, NEG_INF, g)


def slice_width(j: int, nblocks: int) -> int:
    """Candidates per launch of a j-candidate sweep over ``nblocks`` column
    blocks: ``column_slice``'s cap on the scratch (and the grid's 65535
    candidate blocks of 128), spread evenly over the fewest launches, in multiples of 128 (no short last launch, which would
    run its few blocks alone on the card)."""
    cap = min(column_slice(nblocks), _MAX_GRID_Y * TILE_ROWS)
    launches = -(-j // cap)
    return TILE_ROWS * -(-j // (TILE_ROWS * launches))


def _launch(y, yy, selmask, total, diag, lam, idx, metric, rbf_sigma) -> torch.Tensor:
    n, d = y.shape
    j = n if idx is None else idx.shape[0]
    out = torch.empty((j,), dtype=torch.float32, device=y.device)
    if j == 0:
        return out
    # the selected columns' count stays on the card, so the partial scratch is
    # sized for the most column blocks, every column selected
    nblocks = -(-n // TILE_ROWS)
    cols = slice_width(j, nblocks)
    if idx is None and j > cols:
        # sliced through an index: the gathered sweep equals the full sweep
        idx = torch.arange(j, dtype=torch.int32, device=y.device)
    # scratch from the caching allocator (see flmf_gains._launch)
    partial = torch.empty((nblocks, min(j, cols)), dtype=torch.float32, device=y.device)
    sel, nsel = select_cols_cuda(selmask, "nonzero")
    lib = _build.load()
    stream = _build.raw_stream(y)
    for lo in range(0, j, cols):
        hi = min(j, lo + cols)
        rc = lib.gcmf_gains_launch(
            y.data_ptr(), yy.data_ptr(), selmask.data_ptr(), sel.data_ptr(), nsel.data_ptr(),
            total.data_ptr(), diag.data_ptr(), lam.data_ptr(),
            None if idx is None else idx[lo:hi].data_ptr(), n, hi - lo, d, _METRIC_CODE[metric],
            inv_two_sigma_sq(d, rbf_sigma), partial.data_ptr(), out[lo:hi].data_ptr(), stream,
        )
        _build.check(rc, "gcmf_gains kernel")
    return out


def gcmf_gains_cuda(y, yy, selmask, total, diag, lam, metric="dot", rbf_sigma=None) -> torch.Tensor:
    """Launch the full sweep on checked CUDA tensors (see ``ops.gcmf_gains``)."""
    return _launch(y, yy, selmask, total, diag, lam, None, metric, rbf_sigma)


def gcmf_gains_at_cuda(
    y, yy, selmask, total, diag, lam, idx, metric="dot", rbf_sigma=None
) -> torch.Tensor:
    """Launch the gathered sweep; ``idx`` is a contiguous int32 CUDA tensor."""
    return _launch(y, yy, selmask, total, diag, lam, idx, metric, rbf_sigma)
