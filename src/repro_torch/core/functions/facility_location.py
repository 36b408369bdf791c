"""Facility Location:  f(A) = sum_{i in U} max_{j in A} S_ij   (paper §2.1.1).

U is the *represented* set (rows of S) which may differ from the ground set V
(columns of S).  Memoized statistic (paper Table 3): ``curmax_i = max_{j in A}
S_ij`` for every i in U; with it a gain query is one fused relu-reduction,
evaluated for ALL candidates at once.

The per-step gain sweeps are the hotspot.  With the kernel backend
(``use_kernel=True``, or None with a large n on the card) they run through
the hand-written CUDA sweep in ``repro_torch/kernels/fl_gains.py``, in its
full and its gathered-subset form.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import as_float_tensor
from repro_torch.core.functions.base import SetFunction


@dataclasses.dataclass(frozen=True, eq=False)
class FLState:
    curmax: torch.Tensor  # (n_rows,) max similarity of each represented point to A
    n_rows: int


class FLKernelSweep:
    """GainBackend: the CUDA relu-reduce sweep over the similarity matrix
    (full and gathered-subset entry points; see kernels/fl_gains.py)."""

    name = "cuda-fl"

    def full_sweep(self, fn: "FacilityLocation", state: FLState) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.fl_gains(fn.sim, state.curmax)

    def partial_sweep(
        self, fn: "FacilityLocation", state: FLState, idx: torch.Tensor
    ) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.fl_gains_at(fn.sim, state.curmax, idx)


@dataclasses.dataclass(frozen=True, eq=False)
class FacilityLocation(SetFunction):
    sim: torch.Tensor  # (|U|, n) similarity, rows = represented set, cols = ground set
    n: int
    # True/False routes the gain sweeps through the CUDA kernel / plain torch;
    # None defers to the choose_backend heuristic (backends.py)
    use_kernel: bool | None = False

    @staticmethod
    def from_kernel(sim, use_kernel: bool | None = False, device=None) -> "FacilityLocation":
        """FL over a similarity matrix.  A tensor keeps its device; numpy
        input goes to ``device`` (default: the card)."""
        sim = as_float_tensor(sim, device).contiguous()
        return FacilityLocation(sim=sim, n=int(sim.shape[1]), use_kernel=use_kernel)

    def init_state(self) -> FLState:
        # f({}) = 0 with the standard convention max over empty set = 0
        # (requires S >= 0 for monotonicity; similarity.py guarantees this).
        return FLState(
            curmax=torch.zeros((self.sim.shape[0],), dtype=self.sim.dtype, device=self.sim.device),
            n_rows=int(self.sim.shape[0]),
        )

    def gains(self, state: FLState) -> torch.Tensor:
        if self.use_kernel:
            from repro_torch.kernels import ops

            return ops.fl_gains(self.sim, state.curmax)
        return torch.clamp(self.sim - state.curmax[:, None], min=0.0).sum(dim=0)

    def gain_backend(self) -> FLKernelSweep | None:
        from repro_torch.core.optimizers.backends import kernel_enabled

        on = kernel_enabled(self.use_kernel, self.n, device=self.sim.device)
        return FLKernelSweep() if on else None

    def gains_at(self, state: FLState, idxs) -> torch.Tensor:
        cols = self.sim[:, idxs.to(self.sim.device)]  # (|U|, k)
        return torch.clamp(cols - state.curmax[:, None], min=0.0).sum(dim=0)

    def update(self, state: FLState, j) -> FLState:
        # index_select, not sim[:, j]: a 0-d index tensor would be read back
        # to the host
        j = torch.as_tensor(j, device=self.sim.device).reshape(1)
        col = self.sim.index_select(1, j)[:, 0]
        return FLState(curmax=torch.maximum(state.curmax, col), n_rows=state.n_rows)

    def evaluate(self, mask) -> torch.Tensor:
        mask = torch.as_tensor(mask, dtype=torch.bool).to(self.sim.device)
        masked = torch.where(mask[None, :], self.sim, 0.0)
        # max over an empty set is 0 (jnp.max(..., initial=0.0) in the JAX package)
        best = torch.clamp(masked.amax(dim=1), min=0.0)
        return best.sum()

    def evaluate_state(self, state: FLState) -> torch.Tensor:
        return state.curmax.sum()
