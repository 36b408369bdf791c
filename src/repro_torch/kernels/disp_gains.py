"""Dense disparity (dispersion) gain sweeps, stateless, from the selection
mask: the CUDA kernels' launchers and their plain versions.

- ``dsum_gains`` (the port of ``repro/kernels/disp_gains.py::
  dsum_gains_pallas``): ``gains_j = sum_k D[j, k] * m_k``, DisparitySum.
- ``dmin_gains`` (the port of ``dmin_gains_pallas``): ``gains_j =
  min(surr_j, BIG) - curmin`` with ``surr_j = 0`` while ``count == 0``,
  else ``min_{k: m_k > 0} D[j, k]``, DisparityMin's farthest-point
  surrogate.  ``count`` (int32) and ``curmin`` (fp32) are one-element
  tensors on the inputs' device, read by the kernel there.

Both kernels (``csrc/disp_gains.cu``) read the selected columns compacted
on the device by ``select_cols``.  The dsum kernel sums each row over the
columns m_k != 0 in ``row_reduce``'s selected-columns warp order (lane l
adds the list positions t = l, l + 32, ..., then the in-warp halving
tree), an order set by the list alone, for every |A|: a sum has an order,
so a second, streaming branch would change the bits.  Its plain version
below sums the same terms in the same order with the same rounding steps,
so they agree bit for bit.  The dmin kernel gathers the columns m_k > 0
while 8 |A| < n and streams every row above that; the min does not depend
on order at all, so either way it equals the plain version below and the
memoized DisparityMin path bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.row_reduce import reduce_rows, reduce_selected_warp
from repro_torch.kernels.select_cols import picked_cols, scratch, select_cols_cuda

BIG = 1e30  # DisparityMin's "no selected element" distance (core/functions/disparity.py)


def _min_step(acc, s, m):
    return torch.minimum(acc, torch.where(m > 0.0, s, BIG))


def dmin_finish(mind: torch.Tensor, count: torch.Tensor, curmin: torch.Tensor) -> torch.Tensor:
    """The surrogate gain from the masked min ``mind``: ``min(count == 0 ?
    0 : mind, BIG) - curmin`` (also DisparityMin's memoized gains)."""
    surrogate = torch.where(count.reshape(()) == 0, 0.0, mind)
    return torch.clamp(surrogate, max=BIG) - curmin.reshape(())


def dsum_gains_plain(dist: torch.Tensor, selmask: torch.Tensor) -> torch.Tensor:
    """dist (n, n), selmask (n,) -> gains (n,) fp32, in plain PyTorch: the
    sum over the columns m_k != 0 in the kernel's order; holds about
    (256 n) gathered elements of dist at a time."""
    sel = picked_cols(selmask, "nonzero")
    return reduce_selected_warp(dist, None, sel, selmask[sel])


def dmin_gains_plain(
    dist: torch.Tensor, selmask: torch.Tensor, count: torch.Tensor, curmin: torch.Tensor
) -> torch.Tensor:
    """dist (n, n), selmask (n,), count / curmin one-element -> gains (n,)
    fp32, in plain PyTorch."""
    return dmin_finish(reduce_rows(dist, selmask, _min_step, torch.minimum, BIG),
                       count, curmin)


def _launch(name: str, dist: torch.Tensor, *args) -> torch.Tensor:
    """Launch ``name`` on dist and ``args``, tensors or device pointers."""
    n = dist.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=dist.device)
    if n == 0:
        return out
    rc = getattr(_build.load(), f"{name}_launch")(
        dist.data_ptr(), n, *(a if isinstance(a, int) else a.data_ptr() for a in args),
        out.data_ptr(), torch.cuda.current_stream(dist.device).cuda_stream,
    )
    _build.check(rc, f"{name} kernel")
    return out


def dsum_gains_cuda(dist, selmask) -> torch.Tensor:
    """Launch the DisparitySum sweep on checked CUDA tensors (see
    ``ops.dsum_gains``): the launcher compacts the columns m != 0 into the
    scratch, then sweeps."""
    buf, sel, blk = scratch(dist.shape[0], dist.device)  # held until the launch is queued
    return _launch("dsum_gains", dist, selmask, sel, blk)


def dmin_gains_cuda(dist, selmask, count, curmin) -> torch.Tensor:
    """Launch the DisparityMin sweep on checked CUDA tensors (see
    ``ops.dmin_gains``): the compaction of the columns m > 0, then the sweep."""
    if dist.shape[0] == 0:
        return torch.empty((0,), dtype=torch.float32, device=dist.device)
    sel, nsel = select_cols_cuda(selmask, "positive")
    return _launch("dmin_gains", dist, selmask, sel, nsel, count, curmin)
