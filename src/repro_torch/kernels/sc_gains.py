"""Set-cover family gain sweeps: the CUDA kernels' launchers and their plain
versions.

- ``sc_gains`` (the port of ``repro/kernels/sc_gains.py::sc_gains_pallas``):
  ``gains_j = sum_u w_u * max(G[j, u] - covered_u, 0)``, SetCover over its
  (n, m) incidence matrix G.
- ``psc_gains`` (the port of ``psc_gains_pallas``): ``gains_j = sum_u wm_u
  * P[j, u]``, ProbabilisticSetCover over its (n, m) membership
  probabilities P, with ``wm = w * miss`` formed once by the wrapper
  (``ops.psc_gains``) and handed to the kernel or to the plain version.

The kernels (``csrc/sc_gains.cu``) and the plain versions below sum each
row in the same order with the same rounding steps: ``sc_gains`` in
``row_reduce``'s vector warp layout (16-byte loads of G where the launcher
finds the rows and vectors aligned, element loads of the same values
otherwise), ``psc_gains`` in its warp layout.  Both are full sweeps only:
the families' lazy levels take their gathered torch path, as in the JAX
package.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.row_reduce import reduce_rows_warp, reduce_rows_warp4


def sc_gains_plain(cover: torch.Tensor, covered: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """cover (n, m), covered / w (m,) -> gains (n,) fp32, in plain PyTorch;
    holds one (n, 32) block of terms at a time."""
    return reduce_rows_warp4(
        cover, lambda s, cols: torch.clamp(s - covered[cols], min=0.0) * w[cols])


def psc_gains_plain(probs: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """probs (n, m), wm (m,) = w * miss -> gains (n,) fp32, in plain PyTorch."""
    return reduce_rows_warp(probs, None, lambda s, lo, hi: s * wm[lo:hi])


def _launch(name: str, mat: torch.Tensor, *vecs: torch.Tensor) -> torch.Tensor:
    n, m = mat.shape
    out = torch.empty((n,), dtype=torch.float32, device=mat.device)
    if n == 0:
        return out
    rc = getattr(_build.load(), f"{name}_launch")(
        mat.data_ptr(), n, m, *(v.data_ptr() for v in vecs), out.data_ptr(),
        _build.raw_stream(mat),
    )
    _build.check(rc, f"{name} kernel")
    return out


def sc_gains_cuda(cover, covered, w) -> torch.Tensor:
    """Launch the SetCover sweep on checked CUDA tensors (see ``ops.sc_gains``)."""
    return _launch("sc_gains", cover, covered, w)


def psc_gains_cuda(probs, wm) -> torch.Tensor:
    """Launch the ProbabilisticSetCover sweep on checked CUDA tensors, with
    ``wm = w * miss`` formed by ``ops.psc_gains``."""
    return _launch("psc_gains", probs, wm)
