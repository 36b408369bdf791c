"""Concave-Over-Modular MI (paper §3.6, Table 1):

  I(A;Q) = eta * sum_{i in A} psi(sum_{j in Q} S_ij)
           + sum_{j in Q} psi(sum_{i in A} S_ij)

Memoized statistic (Table 4): acc_q = sum_{i in A} S_iq for each query q,
kept as a bare (|Q|,) tensor state.  The first term is modular
(precomputed).  CG/CMI are "Not Useful" per the paper and intentionally
omitted.  Inputs may be numpy arrays or tensors (numpy goes to ``device``,
default the card).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import as_float_tensor, get_concave, one_index
from repro_torch.core.functions.base import SetFunction


@dataclasses.dataclass(frozen=True, eq=False)
class ConcaveOverModular(SetFunction):
    sim_vq: torch.Tensor  # (n, |Q|)
    modular: torch.Tensor  # (n,) eta * psi(sum_q S_iq)
    n: int
    concave: str = "sqrt"

    @staticmethod
    def build(sim_vq, eta: float = 1.0, concave: str = "sqrt",
              device=None) -> "ConcaveOverModular":
        sim_vq = as_float_tensor(sim_vq, device).contiguous()
        psi = get_concave(concave)
        return ConcaveOverModular(
            sim_vq=sim_vq,
            modular=eta * psi(sim_vq.sum(dim=1)),
            n=int(sim_vq.shape[0]),
            concave=concave,
        )

    def init_state(self) -> torch.Tensor:
        return torch.zeros((self.sim_vq.shape[1],), dtype=self.sim_vq.dtype,
                           device=self.sim_vq.device)  # acc_q

    def gains(self, state: torch.Tensor) -> torch.Tensor:
        psi = get_concave(self.concave)
        return self.modular + (psi(state[None, :] + self.sim_vq) - psi(state)[None, :]).sum(dim=1)

    def gains_at(self, state: torch.Tensor, idxs) -> torch.Tensor:
        psi = get_concave(self.concave)
        idxs = idxs.to(self.sim_vq.device)
        rows = self.sim_vq[idxs]
        return self.modular[idxs] + (psi(state[None, :] + rows) - psi(state)[None, :]).sum(dim=1)

    def update(self, state: torch.Tensor, j) -> torch.Tensor:
        return state + self.sim_vq.index_select(0, one_index(j, self.sim_vq.device))[0]

    def evaluate(self, mask) -> torch.Tensor:
        psi = get_concave(self.concave)
        m = torch.as_tensor(mask, dtype=torch.bool).to(self.sim_vq.device)
        acc = torch.where(m[:, None], self.sim_vq, 0.0).sum(dim=0)
        return m.to(self.modular.dtype) @ self.modular + psi(acc).sum()

    def evaluate_state(self, state: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("modular part needs the mask; use evaluate().")
