"""Facility-Location information measures, closed forms (paper Table 1).

FLVMI  I(A;Q)   = sum_i min(max_{j in A} S_ij, eta * max_{j in Q} S_ij)
FLQMI  I(A;Q)   = sum_{q in Q} max_{j in A} S_qj + eta * sum_{i in A} max_q S_iq
FLCG   f(A|P)   = sum_i max(max_{j in A} S_ij - nu * max_{j in P} S_ij, 0)
FLCMI  I(A;Q|P) = sum_i max(min(max_A S_ij, eta qmax_i) - nu pmax_i, 0)

All use the memoized ``curmax`` statistic of FL (paper Table 4), vectorized
over the full candidate set per step, in torch ops (the JAX package has no
kernel for them).  A sweep forms its (|V|, n) temporary once and finishes
it in place, so it holds one such block beside the kernel, not three, and
folds its rows in ``common.row_sums_fixed``'s order: a candidate's gain
then does not depend on how many columns are swept with it (``torch.sum``'s
order follows the column count), so a gathered sweep, a padded served
request and a mesh shard's column slice all give the sequential bits.
FLQMI only needs the (Q × V) kernel — the paper's "very efficient to
optimize" variant used for targeted selection.

Inputs may be numpy arrays or tensors: a tensor ``sim`` keeps its device,
numpy goes to ``device`` (default: the card), and the other inputs follow
``sim``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import as_float_tensor, one_index, row_sums_fixed
from repro_torch.core.functions.base import SetFunction
from repro_torch.core.functions.facility_location import FLState


def _fl_state(sim: torch.Tensor) -> FLState:
    rows = int(sim.shape[0])
    return FLState(curmax=torch.zeros((rows,), dtype=sim.dtype, device=sim.device), n_rows=rows)


def _fl_update(sim: torch.Tensor, state: FLState, j) -> FLState:
    col = sim.index_select(1, one_index(j, sim.device))[:, 0]
    return FLState(curmax=torch.maximum(state.curmax, col), n_rows=state.n_rows)


def _masked_rowmax(sim: torch.Tensor, mask) -> torch.Tensor:
    """max_{j: mask_j} S_ij per row, 0 for an empty mask (the JAX package's
    ``max(..., initial=0.0)``)."""
    mask = torch.as_tensor(mask, dtype=torch.bool).to(sim.device)
    return torch.clamp(torch.where(mask[None, :], sim, 0.0).amax(dim=1), min=0.0)


def _rowmax(a, device) -> torch.Tensor:
    return as_float_tensor(a, device).amax(dim=1)


@dataclasses.dataclass(frozen=True, eq=False)
class FLVMI(SetFunction):
    sim: torch.Tensor  # (|V|, n) ground kernel
    qmax: torch.Tensor  # (|V|,) eta * max_{q in Q} S_iq
    n: int

    @staticmethod
    def build(sim, sim_vq, eta: float = 1.0, device=None) -> "FLVMI":
        sim = as_float_tensor(sim, device).contiguous()
        return FLVMI(sim=sim, qmax=eta * _rowmax(sim_vq, sim.device), n=int(sim.shape[1]))

    def init_state(self) -> FLState:
        return _fl_state(self.sim)

    def _gains(self, state: FLState, cols: torch.Tensor) -> torch.Tensor:
        cur = torch.minimum(state.curmax, self.qmax)  # (|V|,) current contribution
        new = torch.maximum(state.curmax[:, None], cols)
        torch.minimum(new, self.qmax[:, None], out=new)
        return row_sums_fixed(new.sub_(cur[:, None]))

    def gains(self, state: FLState) -> torch.Tensor:
        return self._gains(state, self.sim)

    def gains_at(self, state: FLState, idxs) -> torch.Tensor:
        return self._gains(state, self.sim[:, idxs.to(self.sim.device)])

    def update(self, state: FLState, j) -> FLState:
        return _fl_update(self.sim, state, j)

    def evaluate(self, mask) -> torch.Tensor:
        return torch.minimum(_masked_rowmax(self.sim, mask), self.qmax).sum()

    def evaluate_state(self, state: FLState) -> torch.Tensor:
        return torch.minimum(state.curmax, self.qmax).sum()


@dataclasses.dataclass(frozen=True, eq=False)
class FLQMI(SetFunction):
    sim_qv: torch.Tensor  # (|Q|, n) query-to-ground kernel — the only kernel needed
    modular: torch.Tensor  # (n,) eta * max_{q in Q} S_jq
    n: int
    local_gathers = True  # gains_at's value at an index ignores the others

    @staticmethod
    def build(sim_qv, eta: float = 1.0, device=None) -> "FLQMI":
        sim_qv = as_float_tensor(sim_qv, device).contiguous()
        return FLQMI(sim_qv=sim_qv, modular=eta * sim_qv.amax(dim=0), n=int(sim_qv.shape[1]))

    def init_state(self) -> FLState:
        return _fl_state(self.sim_qv)

    def gains(self, state: FLState) -> torch.Tensor:
        rep = row_sums_fixed(torch.clamp(self.sim_qv - state.curmax[:, None], min=0.0))
        return rep + self.modular

    def gains_at(self, state: FLState, idxs) -> torch.Tensor:
        idxs = idxs.to(self.sim_qv.device)
        rep = row_sums_fixed(torch.clamp(self.sim_qv[:, idxs] - state.curmax[:, None], min=0.0))
        return rep + self.modular[idxs]

    def update(self, state: FLState, j) -> FLState:
        return _fl_update(self.sim_qv, state, j)

    def evaluate(self, mask) -> torch.Tensor:
        m = torch.as_tensor(mask, device=self.modular.device)
        return _masked_rowmax(self.sim_qv, m).sum() + m.to(self.modular.dtype) @ self.modular

    def evaluate_state(self, state: FLState) -> torch.Tensor:
        raise NotImplementedError("modular part needs the mask; use evaluate().")


@dataclasses.dataclass(frozen=True, eq=False)
class FLCG(SetFunction):
    sim: torch.Tensor  # (|V|, n)
    pmax: torch.Tensor  # (|V|,) nu * max_{p in P} S_ip
    n: int

    @staticmethod
    def build(sim, sim_vp, nu: float = 1.0, device=None) -> "FLCG":
        sim = as_float_tensor(sim, device).contiguous()
        return FLCG(sim=sim, pmax=nu * _rowmax(sim_vp, sim.device), n=int(sim.shape[1]))

    def init_state(self) -> FLState:
        return _fl_state(self.sim)

    def _gains(self, state: FLState, cols: torch.Tensor) -> torch.Tensor:
        cur = torch.clamp(state.curmax - self.pmax, min=0.0)
        new = torch.maximum(state.curmax[:, None], cols).sub_(self.pmax[:, None]).clamp_(min=0.0)
        return row_sums_fixed(new.sub_(cur[:, None]))

    def gains(self, state: FLState) -> torch.Tensor:
        return self._gains(state, self.sim)

    def gains_at(self, state: FLState, idxs) -> torch.Tensor:
        return self._gains(state, self.sim[:, idxs.to(self.sim.device)])

    def update(self, state: FLState, j) -> FLState:
        return _fl_update(self.sim, state, j)

    def evaluate(self, mask) -> torch.Tensor:
        return torch.clamp(_masked_rowmax(self.sim, mask) - self.pmax, min=0.0).sum()

    def evaluate_state(self, state: FLState) -> torch.Tensor:
        return torch.clamp(state.curmax - self.pmax, min=0.0).sum()


@dataclasses.dataclass(frozen=True, eq=False)
class FLCMI(SetFunction):
    sim: torch.Tensor  # (|V|, n)
    qmax: torch.Tensor  # (|V|,) eta-scaled
    pmax: torch.Tensor  # (|V|,) nu-scaled
    n: int

    @staticmethod
    def build(sim, sim_vq, sim_vp, eta: float = 1.0, nu: float = 1.0,
              device=None) -> "FLCMI":
        sim = as_float_tensor(sim, device).contiguous()
        return FLCMI(
            sim=sim,
            qmax=eta * _rowmax(sim_vq, sim.device),
            pmax=nu * _rowmax(sim_vp, sim.device),
            n=int(sim.shape[1]),
        )

    def _contrib(self, curmax: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.minimum(curmax, self.qmax) - self.pmax, min=0.0)

    def init_state(self) -> FLState:
        return _fl_state(self.sim)

    def _gains(self, state: FLState, cols: torch.Tensor) -> torch.Tensor:
        cur = self._contrib(state.curmax)
        new = torch.maximum(state.curmax[:, None], cols)
        torch.minimum(new, self.qmax[:, None], out=new)
        new.sub_(self.pmax[:, None]).clamp_(min=0.0)
        return row_sums_fixed(new.sub_(cur[:, None]))

    def gains(self, state: FLState) -> torch.Tensor:
        return self._gains(state, self.sim)

    def gains_at(self, state: FLState, idxs) -> torch.Tensor:
        return self._gains(state, self.sim[:, idxs.to(self.sim.device)])

    def update(self, state: FLState, j) -> FLState:
        return _fl_update(self.sim, state, j)

    def evaluate(self, mask) -> torch.Tensor:
        return self._contrib(_masked_rowmax(self.sim, mask)).sum()

    def evaluate_state(self, state: FLState) -> torch.Tensor:
        return self._contrib(state.curmax).sum()
