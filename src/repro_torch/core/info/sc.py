"""Set-Cover / Probabilistic-Set-Cover information measures (paper §5.2.2-4).

Each measure IS the base function with a modified cover set or reweighted
concepts, the paper's own implementation trick:

  SCMI    = SC with concepts restricted to Γ(Q)
  SCCG    = SC with concepts outside Γ(P)
  SCCMI   = SC with concepts in Γ(Q) \\ Γ(P)
  PSCMI   = PSC with weights w_u * (1 - P_u(Q))
  PSCCG   = PSC with weights w_u * P_u(P)
  PSCCMI  = PSC with weights w_u * (1 - P_u(Q)) * P_u(P)

Every measure is a SetCover / ProbabilisticSetCover instance, so
``use_kernel`` (forwarded) routes its sweeps through the same CUDA kernels.
The inputs may be numpy arrays or tensors; they go to the device of
``cover`` / ``probs`` (numpy: ``device``, default the card).
"""
from __future__ import annotations

import torch

from repro_torch.common import as_float_tensor
from repro_torch.core.functions.set_cover import ProbabilisticSetCover, SetCover


def _concepts_of(cover_rows, device) -> torch.Tensor:
    """(k, m) cover rows -> (m,) indicator of concepts covered by the set."""
    rows = as_float_tensor(cover_rows, device)
    if rows.shape[0] == 0:
        return rows.new_zeros((rows.shape[1],))
    return torch.clamp(rows.amax(dim=0), min=0.0)


def _miss(probs_rows, device) -> torch.Tensor:
    """(k, m) membership probabilities -> (m,) P_u(set) = prod (1 - p)."""
    return torch.prod(1.0 - as_float_tensor(probs_rows, device), dim=0)


def _sc(cover, w, weights, use_kernel, device) -> SetCover:
    """SetCover over ``cover`` with the weights ``weights(w, device)``."""
    cover = as_float_tensor(cover, device)
    return SetCover.from_cover(cover, weights(as_float_tensor(w, cover.device), cover.device),
                               use_kernel=use_kernel)


def sc_mi(cover, w, cover_q, use_kernel: bool | None = False, device=None) -> SetCover:
    return _sc(cover, w, lambda w, dev: w * _concepts_of(cover_q, dev), use_kernel, device)


def sc_cg(cover, w, cover_p, use_kernel: bool | None = False, device=None) -> SetCover:
    return _sc(cover, w, lambda w, dev: w * (1.0 - _concepts_of(cover_p, dev)), use_kernel,
               device)


def sc_cmi(cover, w, cover_q, cover_p, use_kernel: bool | None = False,
           device=None) -> SetCover:
    return _sc(cover, w,
               lambda w, dev: w * (_concepts_of(cover_q, dev) * (1.0 - _concepts_of(cover_p, dev))),
               use_kernel, device)


def _psc(probs, w, weights, use_kernel, device) -> ProbabilisticSetCover:
    """ProbabilisticSetCover over ``probs`` with the weights ``weights(w, device)``."""
    probs = as_float_tensor(probs, device)
    return ProbabilisticSetCover.from_probs(
        probs, weights(as_float_tensor(w, probs.device), probs.device), use_kernel=use_kernel)


def psc_mi(probs, w, probs_q, use_kernel: bool | None = False,
           device=None) -> ProbabilisticSetCover:
    return _psc(probs, w, lambda w, dev: w * (1.0 - _miss(probs_q, dev)), use_kernel, device)


def psc_cg(probs, w, probs_p, use_kernel: bool | None = False,
           device=None) -> ProbabilisticSetCover:
    return _psc(probs, w, lambda w, dev: w * _miss(probs_p, dev), use_kernel, device)


def psc_cmi(probs, w, probs_q, probs_p, use_kernel: bool | None = False,
            device=None) -> ProbabilisticSetCover:
    return _psc(probs, w,
                lambda w, dev: w * (1.0 - _miss(probs_q, dev)) * _miss(probs_p, dev),
                use_kernel, device)
