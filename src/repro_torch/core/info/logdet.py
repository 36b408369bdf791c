"""Log-Determinant information measures (paper §3.4, Table 1).

Built from projected kernels + the difference combinator:

  LogDetMI  (A;Q)   = logdet(S_A) - logdet((S - eta^2 S_.Q S_Q^-1 S_.Q^T)_A)
  LogDetCG  (A|P)   = logdet((S - nu^2 S_.P S_P^-1 S_.P^T)_A)
  LogDetCMI (A;Q|P) = LogDetCG_P(A) - LogDetCG_{Q∪P}(A)

each term being a plain LogDet on a Schur-complement kernel, so the
incremental-Cholesky memoization applies unchanged.  The Schur complement
is an fp32 ``torch.linalg.solve`` with a 1e-6 jitter, as in the JAX
package; where S is near-singular its pivots sit near LogDet's 1e-12 floor.
Inputs may be numpy arrays or tensors: a tensor ``S`` keeps its device,
numpy goes to ``device`` (default: the card), the blocks follow ``S``.
"""
from __future__ import annotations

import torch

from repro_torch.common import as_float_tensor
from repro_torch.core.functions.log_det import LogDet
from repro_torch.core.info.combinators import DifferenceFunction

_JITTER = 1e-6


def _schur(S, S_vc, S_cc, scale) -> torch.Tensor:
    """S - scale^2 * S_vc S_cc^-1 S_vc^T, with jitter for stability."""
    S_vc = as_float_tensor(S_vc, S.device)
    S_cc = as_float_tensor(S_cc, S.device)
    reg = S_cc + _JITTER * torch.eye(S_cc.shape[0], dtype=S_cc.dtype, device=S.device)
    sol = torch.linalg.solve(reg, S_vc.T)  # (|C|, n)
    # scaled in place on the fresh product: one (n, n) temporary, not two
    return S - (S_vc @ sol).mul_(scale * scale)


def logdet_mi(S, S_vq, S_qq, eta: float = 1.0, max_select: int | None = None,
              device=None) -> DifferenceFunction:
    S = as_float_tensor(S, device)
    f1 = LogDet.from_kernel(S, max_select)
    f2 = LogDet.from_kernel(_schur(S, S_vq, S_qq, eta), max_select)
    return DifferenceFunction.build(f1, f2, int(S.shape[0]))


def logdet_cg(S, S_vp, S_pp, nu: float = 1.0, max_select: int | None = None,
              device=None) -> LogDet:
    S = as_float_tensor(S, device)
    return LogDet.from_kernel(_schur(S, S_vp, S_pp, nu), max_select)


def logdet_cmi(S, S_vq, S_qq, S_vp, S_pp, S_qp, eta: float = 1.0, nu: float = 1.0,
               max_select: int | None = None, device=None) -> DifferenceFunction:
    S = as_float_tensor(S, device)
    dev = S.device
    f1 = logdet_cg(S, S_vp, S_pp, nu, max_select)
    # joint conditioning set Q ∪ P with eta/nu cross-scaling on the V side
    S_vqp = torch.cat([eta * as_float_tensor(S_vq, dev), nu * as_float_tensor(S_vp, dev)], dim=1)
    S_qp = as_float_tensor(S_qp, dev)
    top = torch.cat([as_float_tensor(S_qq, dev), S_qp], dim=1)
    bot = torch.cat([S_qp.T, as_float_tensor(S_pp, dev)], dim=1)
    f2 = LogDet.from_kernel(_schur(S, S_vqp, torch.cat([top, bot], dim=0), 1.0), max_select)
    return DifferenceFunction.build(f1, f2, int(S.shape[0]))
