"""Fused dot similarity + facility-location gain sweep: the CUDA kernel's
launcher and its plain version.

``gains_j = sum_i max(<x_i, y_j> - curmax_i, 0)`` for x (u, d) represented
rows, y (n, d) candidates (each fp32 or bf16) and curmax (u,), in fp32,
without writing the (u, n) similarity: the port of
``repro/kernels/fused_fl_sweep.py::fused_fl_sweep_pallas``.  Dot metric
only; callers pre-normalise rows for cosine.

The JAX function's tile knobs ``bu`` / ``bn`` / ``bk`` and ``interpret``
have no meaning here and are not ported: the kernel's tile is fixed
(``csrc/sgemm_pipe.cuh``), and the plain version below is what runs on the
CPU.  Where the JAX wrapper pads u with curmax rows of ``_PAD_CM = 3e38``
(whose relu is exactly 0), the kernel skips rows past u; padded columns do
not exist, as every column is masked at the ragged edge.

The kernel (``csrc/fused_fl_sweep.cu``) reads bf16 operands as they are and
widens them in shared memory, with no fp32 copy in device memory.  It sums
each column in an order that depends on u and d alone, so a sweep over a
slice or a gather of y equals the full sweep bit for bit at the same row,
and on fp32 inputs it equals ``flmf_gains(..., metric="dot")`` (the same
fmaf chains and order, on the same mainloop).  The kernel's launcher
copies rows 16 bytes at a time where every row is 16-byte aligned, else
element by element, with the same bits.  :func:`fused_fl_sweep_plain`, the
counterpart of ``fused_fl_sweep_ref``, widens one fixed-width column tile
at a time and adds with ``sum``; it agrees with the kernel to a tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.common import pad_rows
from repro_torch.kernels import _build
from repro_torch.kernels.flmf_gains import TILE_ROWS, column_slice
from repro_torch.kernels.similarity_kernel import TILE

DTYPES = (torch.float32, torch.bfloat16)


def fused_fl_sweep_plain(x: torch.Tensor, y: torch.Tensor, curmax: torch.Tensor) -> torch.Tensor:
    """x (u, d), y (n, d) fp32 or bf16, curmax (u,) -> gains (n,) fp32, in
    plain PyTorch: each block of TILE candidates is widened to fp32 and
    multiplied as one fixed-shape matmul, so a column's value does not
    depend on its position.  Holds one (u, TILE) block at a time."""
    xf = x.float()
    cm = curmax.float()[:, None]
    out = torch.empty((y.shape[0],), dtype=torch.float32, device=y.device)
    for lo in range(0, y.shape[0], TILE):
        w = min(TILE, y.shape[0] - lo)
        s = xf @ pad_rows(y[lo : lo + w].float(), TILE).T
        out[lo : lo + w] = torch.clamp(s - cm, min=0.0).sum(dim=0)[:w]
    return out


def fused_fl_sweep_cuda(x: torch.Tensor, y: torch.Tensor, curmax: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked, contiguous CUDA tensors (see
    ``ops.fused_fl_sweep``); x and y each fp32 or bf16, curmax fp32."""
    u, d = x.shape
    n = y.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=y.device)
    if n == 0:
        return out
    if u == 0:  # no rows: every sum is empty
        return out.zero_()
    nblocks = -(-u // TILE_ROWS)
    cols = column_slice(nblocks)
    # scratch from the caching allocator, reused by every column slice
    partial = torch.empty((nblocks, min(n, cols)), dtype=torch.float32, device=y.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    row_bytes = d * y.element_size()
    for lo in range(0, n, cols):
        hi = min(n, lo + cols)
        rc = lib.fused_fl_sweep_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            y.data_ptr() + lo * row_bytes, int(y.dtype == torch.bfloat16),
            curmax.data_ptr(), u, hi - lo, d, partial.data_ptr(), out[lo:hi].data_ptr(), stream,
        )
        _build.check(rc, "fused_fl_sweep kernel")
    return out
