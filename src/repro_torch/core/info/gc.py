"""Graph-Cut information measures (paper Table 1).

GCMI   I(A;Q)  = 2 * lam * sum_{i in A, j in Q} S_ij     (pure modular — the
                 paper's "pure retrieval" function, Fig. 8)
GCCG   f(A|P)  = f_lam(A) - 2 * lam * nu * sum_{i in A, j in P} S_ij
                 (= GraphCut with a modular penalty folded into ``total``)
GCCMI  == GCMI (paper: the CMI expression does not involve P).

GCMI's state is a bare 0-d tensor (the running value); ``gccg`` returns a
port :class:`GraphCut`, so ``use_kernel`` routes its sweeps through the
``gc_gains`` / ``gc_gains_at`` kernels.  Inputs may be numpy arrays or
tensors (numpy goes to ``device``, default the card).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import as_float_tensor, one_index
from repro_torch.core.functions.base import SetFunction
from repro_torch.core.functions.graph_cut import GraphCut


@dataclasses.dataclass(frozen=True, eq=False)
class GCMI(SetFunction):
    qsum: torch.Tensor  # (n,) 2*lam*sum_{j in Q} S_ij — a modular function
    n: int
    local_gathers = True  # gains_at's value at an index ignores the others

    @staticmethod
    def build(sim_vq, lam: float = 1.0, device=None) -> "GCMI":
        sim_vq = as_float_tensor(sim_vq, device)  # (n, |Q|)
        return GCMI(qsum=2.0 * lam * sim_vq.sum(dim=1), n=int(sim_vq.shape[0]))

    def init_state(self) -> torch.Tensor:
        return torch.zeros((), dtype=self.qsum.dtype, device=self.qsum.device)  # running value

    def gains(self, state) -> torch.Tensor:
        return self.qsum

    def gains_at(self, state, idxs) -> torch.Tensor:
        return self.qsum[idxs.to(self.qsum.device)]

    def update(self, state, j) -> torch.Tensor:
        return state + self.qsum.index_select(0, one_index(j, self.qsum.device)).reshape(())

    def evaluate(self, mask) -> torch.Tensor:
        m = torch.as_tensor(mask, device=self.qsum.device).to(self.qsum.dtype)
        return m @ self.qsum

    def evaluate_state(self, state) -> torch.Tensor:
        return state


def gccg(sim_ground, sim_vp, lam: float = 0.5, nu: float = 1.0, sim_rep=None,
         use_kernel: bool | None = False, device=None) -> GraphCut:
    """GCCG as a GraphCut instance with the private-set penalty folded in."""
    base = GraphCut.from_kernel(sim_ground, lam=lam, sim_rep=sim_rep, use_kernel=use_kernel,
                                device=device)
    penalty = 2.0 * lam * nu * as_float_tensor(sim_vp, base.sim_ground.device).sum(dim=1)
    return dataclasses.replace(base, total=base.total - penalty)


gccmi = GCMI.build  # paper: GCCMI expression is identical to GCMI
