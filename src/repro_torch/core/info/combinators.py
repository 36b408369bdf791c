"""Generic MI / CG / CMI combinators (paper §3).

Any submodular information measure decomposes into two primitives:

  ConditionedFunction   g(A) = f(A ∪ C) - f(C)              (= CG with C = P)
  DifferenceFunction    g(A) = f1(A) - f2(A)

because  I_f(A;Q)   = f(A) - f(A|Q)                         (MI)
         I_f(A;Q|P) = f(A|P) - f(A|Q ∪ P)                   (CMI)

The base function must be built over the *extended* ground set V ∪ Q ∪ P
(see ``similarity.build_extended_kernel``), with V at indices [0, n_v).
These generic forms are the correctness oracles for the closed-form
instantiations (fl.py, gc.py, logdet.py, sc.py).

A ConditionedFunction's state is its base's state; a DifferenceFunction's
is the tuple (state of f1, state of f2), which the engines select leaf by
leaf (``greedy._where_state``).  Both sweep through the base functions'
plain ``gains()`` / ``gains_at()``, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common import mask_from_indices
from repro_torch.core.functions.base import SetFunction


def _base_device(base: SetFunction) -> torch.device:
    """The device of a base function's first tensor field."""
    for f in dataclasses.fields(base):
        v = getattr(base, f.name)
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, SetFunction):
            return _base_device(v)
        if hasattr(v, "device"):  # a similarity source
            return v.device
    raise ValueError(f"{type(base).__name__} holds no tensor to take a device from")


def _as_index(idx) -> torch.Tensor:
    """Indices (a tensor, numpy array or list) as a 1-D int64 tensor."""
    t = idx if isinstance(idx, torch.Tensor) else torch.tensor(np.asarray(idx))
    return t.to(torch.long).reshape(-1)


@dataclasses.dataclass(frozen=True, eq=False)
class ConditionedFunction(SetFunction):
    base: SetFunction
    cond_idx: torch.Tensor  # int64 indices (in the base ground set) of C
    n: int  # selectable prefix size n_v

    @staticmethod
    def build(base: SetFunction, cond_idx, n_select: int) -> "ConditionedFunction":
        idx = _as_index(cond_idx).to(_base_device(base))
        return ConditionedFunction(base=base, cond_idx=idx, n=int(n_select))

    def init_state(self):
        state = self.base.init_state()
        for i in range(self.cond_idx.shape[0]):  # the JAX package's fori_loop
            state = self.base.update(state, self.cond_idx[i : i + 1])
        return state

    def gains(self, state) -> torch.Tensor:
        return self.base.gains(state)[: self.n]

    def gains_at(self, state, idxs) -> torch.Tensor:
        return self.base.gains_at(state, idxs)

    def update(self, state, j):
        return self.base.update(state, j)

    def _cond_mask(self) -> torch.Tensor:
        return mask_from_indices(self.cond_idx, self.base.n)

    def evaluate(self, mask) -> torch.Tensor:
        cmask = self._cond_mask()
        mask = torch.as_tensor(mask, dtype=torch.bool, device=cmask.device)
        full = torch.nn.functional.pad(mask, (0, self.base.n - self.n)) | cmask
        return self.base.evaluate(full) - self.base.evaluate(cmask)


@dataclasses.dataclass(frozen=True, eq=False)
class DifferenceFunction(SetFunction):
    f1: SetFunction
    f2: SetFunction
    n: int

    @staticmethod
    def build(f1: SetFunction, f2: SetFunction, n: int) -> "DifferenceFunction":
        return DifferenceFunction(f1=f1, f2=f2, n=int(n))

    def init_state(self):
        return (self.f1.init_state(), self.f2.init_state())

    def gains(self, state) -> torch.Tensor:
        s1, s2 = state
        return self.f1.gains(s1)[: self.n] - self.f2.gains(s2)[: self.n]

    def gains_at(self, state, idxs) -> torch.Tensor:
        s1, s2 = state
        return self.f1.gains_at(s1, idxs) - self.f2.gains_at(s2, idxs)

    def update(self, state, j):
        s1, s2 = state
        return (self.f1.update(s1, j), self.f2.update(s2, j))

    def evaluate(self, mask) -> torch.Tensor:
        mask = torch.as_tensor(mask, dtype=torch.bool)
        m1 = torch.nn.functional.pad(mask, (0, self.f1.n - self.n))
        m2 = torch.nn.functional.pad(mask, (0, self.f2.n - self.n))
        return self.f1.evaluate(m1) - self.f2.evaluate(m2)


def generic_mi(base: SetFunction, q_idx, n_select: int) -> DifferenceFunction:
    """I_f(A;Q) = f(A) - f(A|Q), as a set function of A ⊆ V."""
    return DifferenceFunction.build(
        base, ConditionedFunction.build(base, q_idx, n_select), n_select
    )


def generic_cg(base: SetFunction, p_idx, n_select: int) -> ConditionedFunction:
    """f(A|P)."""
    return ConditionedFunction.build(base, p_idx, n_select)


def generic_cmi(base: SetFunction, q_idx, p_idx, n_select: int) -> DifferenceFunction:
    """I_f(A;Q|P) = f(A|P) - f(A|Q ∪ P)."""
    qp = torch.cat([_as_index(q_idx).cpu(), _as_index(p_idx).cpu()])
    return DifferenceFunction.build(
        ConditionedFunction.build(base, p_idx, n_select),
        ConditionedFunction.build(base, qp, n_select),
        n_select,
    )
