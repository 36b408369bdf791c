"""Dense graph-cut gain sweeps (stateless, from the selection mask): the CUDA
kernel's launchers and their plain versions.

``gains_j = total_j - lam * sum_k S[j, k] * (2 * m_k + [j == k])`` over a
materialised (n, n) ground kernel S, for every candidate (``gc_gains``, the
port of ``repro/kernels/gc_gains.py::gc_gains_pallas``) or for the rows
``idx`` (``gc_gains_at``, the port of ``gc_gains_at_pallas``; slots with
idx < 0 return NEG_INF, idx >= n reads row n - 1).  ``lam`` is a
one-element tensor on the inputs' device, read by the kernel there.

The kernel (``csrc/gc_gains.cu``) reads only the selected columns
(m_k != 0, compacted on the device by ``select_cols``): it sums
``S[j, k] * 2 m_k`` over them in ``row_reduce``'s selected-columns warp
order (lane l adds the list positions t = l, l + 32, ..., then the in-warp
halving tree), an order set by the list alone, for every |A| (a sum has an
order, so a second, streaming branch would change the bits), then adds the
diagonal ``S[j, j]`` once, from the row's global id.  The plain versions
below do the same steps in the same order with the same roundings, so the
gathered sweep equals the full sweep bit for bit at the same index, and
kernel and plain version agree bit for bit as well.
"""
from __future__ import annotations

import torch

from repro_torch.common import NEG_INF
from repro_torch.kernels import _build
from repro_torch.kernels.row_reduce import reduce_selected_warp
from repro_torch.kernels.select_cols import picked_cols, scratch


def _plain(sim, selmask, total, lam, rows) -> torch.Tensor:
    sel = picked_cols(selmask, "nonzero")
    acc = reduce_selected_warp(sim, rows, sel, 2.0 * selmask[sel])
    diag = torch.diagonal(sim) if rows is None else sim[rows, rows]
    return (total if rows is None else total[rows]) - lam.reshape(()) * (acc + diag)


def gc_gains_plain(
    sim: torch.Tensor, selmask: torch.Tensor, total: torch.Tensor, lam: torch.Tensor
) -> torch.Tensor:
    """sim (n, n), selmask / total (n,), lam one-element -> gains (n,) fp32,
    in plain PyTorch; holds about (256 n) gathered elements of sim at a time."""
    return _plain(sim, selmask, total, lam, None)


def gc_gains_at_plain(
    sim: torch.Tensor, selmask: torch.Tensor, total: torch.Tensor, lam: torch.Tensor,
    idx: torch.Tensor,
) -> torch.Tensor:
    """Gathered sweep in plain PyTorch: idx (k,) -> gains (k,); idx < 0 ->
    NEG_INF, bit-identical to :func:`gc_gains_plain` at the same index."""
    idx = idx.to(device=sim.device, dtype=torch.long)
    g = _plain(sim, selmask, total, lam, torch.clamp(idx, 0, sim.shape[0] - 1))
    return torch.where(idx < 0, NEG_INF, g)


def _launch(sim, selmask, total, lam, idx) -> torch.Tensor:
    n = sim.shape[0]
    k = n if idx is None else idx.shape[0]
    out = torch.empty((k,), dtype=torch.float32, device=sim.device)
    if k == 0:
        return out
    buf, sel, blk = scratch(n, sim.device)  # held until the launch is queued
    rc = _build.load().gc_gains_launch(
        sim.data_ptr(), n, selmask.data_ptr(), sel, blk, total.data_ptr(), lam.data_ptr(),
        None if idx is None else idx.data_ptr(), k, out.data_ptr(),
        torch.cuda.current_stream(sim.device).cuda_stream,
    )
    _build.check(rc, "gc_gains kernel")
    return out


def gc_gains_cuda(sim, selmask, total, lam) -> torch.Tensor:
    """Launch the full sweep on checked CUDA tensors (see ``ops.gc_gains``):
    the launcher compacts the columns m != 0, then sweeps."""
    return _launch(sim, selmask, total, lam, None)


def gc_gains_at_cuda(sim, selmask, total, lam, idx) -> torch.Tensor:
    """Launch the gathered sweep; ``idx`` is a contiguous int32 CUDA tensor."""
    return _launch(sim, selmask, total, lam, idx)
