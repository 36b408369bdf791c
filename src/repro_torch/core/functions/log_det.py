"""Log Determinant (DPP MAP):  f(A) = log det(L_A)   (paper §2.2.2).

Fast Greedy MAP Inference [Chen et al., NeurIPS'18] via incremental
Cholesky factors, vectorized over every candidate at once.  For each ground
element i the state keeps

  c_i  in R^{b}    : row of the Cholesky factor of L_{A + i} restricted to A
  d2_i in R        : squared Cholesky pivot = det(L_{A+i}) / det(L_A)

so the marginal gain is  f(i|A) = log d2_i,  and adding j* updates every
candidate with one rank-1 step:

  e_i  = (L_{i,j*} - <c_i, c_{j*}>) / d_{j*}
  c_i <- [c_i, e_i],     d2_i <- d2_i - e_i^2

The candidate buffer C is allocated at ``max_select`` columns.  The update
uses the elementwise-multiply + reduce form ``(C * c_j).sum(1)``, the JAX
package's form (it keeps batched and sequential runs bit-identical there),
and writes column ``count`` out of place with a select, so an engine that
keeps the old state (``greedy._where_state``) still has it; at ``count ==
max_select`` the write is dropped, as the JAX package's
``.at[:, count].set(e, mode="drop")``.  ``count`` stays on the device: no
step reads it back.  Torch ops only; the JAX package has no kernel here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import NEG_INF, as_float_tensor, one_index
from repro_torch.core.functions.base import SetFunction

_EPS = 1e-12


@dataclasses.dataclass(frozen=True, eq=False)
class LogDetState:
    C: torch.Tensor  # (n, max_select) candidate Cholesky rows (zero-padded)
    d2: torch.Tensor  # (n,) pivot^2 for every candidate
    count: torch.Tensor  # 0-d int32 number of selected items
    value: torch.Tensor  # 0-d running log det


def _log_pivot(d2: torch.Tensor) -> torch.Tensor:
    return torch.where(d2 > _EPS, torch.log(torch.clamp(d2, min=_EPS)), NEG_INF)


@dataclasses.dataclass(frozen=True, eq=False)
class LogDet(SetFunction):
    L: torch.Tensor  # (n, n) PSD similarity kernel
    n: int
    local_gathers = True  # gains_at's value at an index ignores the others
    max_select: int

    @staticmethod
    def from_kernel(L, max_select: int | None = None, device=None) -> "LogDet":
        """LogDet over a PSD kernel.  A tensor keeps its device; numpy input
        goes to ``device`` (default: the card)."""
        L = as_float_tensor(L, device).contiguous()
        n = int(L.shape[0])
        return LogDet(L=L, n=n, max_select=int(max_select or n))

    def init_state(self) -> LogDetState:
        dev = self.L.device
        return LogDetState(
            C=torch.zeros((self.n, self.max_select), dtype=self.L.dtype, device=dev),
            d2=torch.diagonal(self.L).clone(),
            count=torch.zeros((), dtype=torch.int32, device=dev),
            value=torch.zeros((), dtype=self.L.dtype, device=dev),
        )

    def gains(self, state: LogDetState) -> torch.Tensor:
        return _log_pivot(state.d2)

    def gains_at(self, state: LogDetState, idxs) -> torch.Tensor:
        return _log_pivot(state.d2[idxs.to(state.d2.device)])

    def update(self, state: LogDetState, j) -> LogDetState:
        j = one_index(j, self.L.device)
        cj = state.C.index_select(0, j)  # (1, max_select)
        d2j = state.d2.index_select(0, j)  # (1,)
        dj = torch.sqrt(torch.clamp(d2j, min=_EPS))
        # e_i for every candidate i at once; reduce form, not `C @ cj`
        e = (self.L.index_select(1, j)[:, 0] - (state.C * cj).sum(dim=1)) / dj  # (n,)
        cols = torch.arange(self.max_select, device=self.L.device)
        C = torch.where((cols == state.count)[None, :], e[:, None], state.C)
        return LogDetState(
            C=C,
            d2=state.d2 - e * e,
            count=state.count + 1,
            value=state.value + torch.log(torch.clamp(d2j, min=_EPS)).reshape(()),
        )

    def evaluate(self, mask) -> torch.Tensor:
        # log det of the masked submatrix: pad unselected rows/cols with the
        # identity so the determinant is unchanged.
        m = torch.as_tensor(mask, device=self.L.device).to(self.L.dtype)
        Lm = self.L * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        _, logdet = torch.linalg.slogdet(Lm)
        return torch.where(m.sum() > 0, logdet, 0.0)

    def evaluate_state(self, state: LogDetState) -> torch.Tensor:
        return state.value
