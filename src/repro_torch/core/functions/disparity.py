"""Dispersion / Disparity functions (paper §2.2.1).

DisparitySum    f(X) = (1/2) sum_{i,j in X} d_ij          (supermodular)
DisparityMin    f(X) = min_{i!=j in X} d_ij               (not submodular)
DisparityMinSum f(X) = sum_{i in X} min_{j in X, j!=i} d_ij  (submodular [6])

Conventions: f(X) = 0 for |X| <= 1 for the min-based variants; DisparitySum
counts each unordered pair once.

As in the JAX package, DisparityMin is optimized with the dispersion greedy
of Dasgupta et al. [11]: ``gains`` returns the surrogate ``min_{k in A} d_jk
- f(A)``, whose argmax is the farthest-point rule; ``evaluate`` remains the
true set function.

``use_kernel=True`` on DisparitySum / DisparityMin routes full sweeps through
the CUDA kernels of ``kernels/disp_gains.py``: stateless sweeps recomputed
from the selection mask kept in the state, one pass over the (n, n)
distances each.  They have no gathered form, so the lazy engine's subset
sweeps take the memoized ``gains_at``.  DisparityMin's masked min equals
the memoized ``mind`` bit for bit; DisparitySum's sum runs in another order
than the incremental ``selsum`` and agrees to ulps.

DisparityMinSum has no kernel.  Its gains need, for every candidate j, the
sum over the selected rows i of ``min(t_i, d_ij) - t_i``: the port gathers
the |A| selected rows (O(|A| n), one host sync to find them) where the JAX
package masks all n rows, an (n, n) temporary.  It computes the same
function.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import as_float_tensor, one_index
from repro_torch.core.functions.base import SetFunction
from repro_torch.core.optimizers.spec import register_family_defaults
from repro_torch.kernels.disp_gains import BIG as _BIG
from repro_torch.kernels.disp_gains import dmin_finish


def _pair_block(dist: torch.Tensor, mask) -> torch.Tensor:
    """d_ij over the pairs i != j of ``mask``: an (|A|, |A|) block with BIG
    on its diagonal (one host sync to find the members)."""
    sel = torch.nonzero(torch.as_tensor(mask, device=dist.device).to(torch.bool))[:, 0]
    block = dist[sel[:, None], sel[None, :]]
    return block.fill_diagonal_(_BIG)


# -- DisparitySum --------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class DSumState:
    selsum: torch.Tensor  # (n,) sum_{k in A} d_jk
    selmask: torch.Tensor  # (n,) fp32 0/1 selection indicator (feeds the stateless sweep)


class DSumKernelSweep:
    """GainBackend: the stateless masked row-sum sweep over the distances
    (kernels/disp_gains.py); full sweeps only."""

    name = "cuda-dsum"

    def full_sweep(self, fn: "DisparitySum", state: DSumState) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.dsum_gains(fn.dist, state.selmask)


@dataclasses.dataclass(frozen=True, eq=False)
class DisparitySum(SetFunction):
    dist: torch.Tensor  # (n, n) pairwise distances, zero diagonal
    n: int
    local_gathers = True  # gains_at's value at an index ignores the others
    # True/False routes full sweeps through the CUDA kernel / plain torch;
    # None defers to the choose_backend table (backends.py)
    use_kernel: bool | None = False

    @staticmethod
    def from_distance(dist, use_kernel: bool | None = False, device=None) -> "DisparitySum":
        """A tensor keeps its device; numpy input goes to ``device`` (default: the card)."""
        dist = as_float_tensor(dist, device).contiguous()
        return DisparitySum(dist=dist, n=int(dist.shape[0]), use_kernel=use_kernel)

    def init_state(self) -> DSumState:
        zeros = torch.zeros((self.n,), dtype=torch.float32, device=self.dist.device)
        return DSumState(selsum=zeros, selmask=zeros.clone())

    def gains(self, state: DSumState) -> torch.Tensor:
        return state.selsum

    def gains_at(self, state: DSumState, idxs) -> torch.Tensor:
        return state.selsum[idxs.to(self.dist.device)]

    def gain_backend(self) -> DSumKernelSweep | None:
        from repro_torch.core.optimizers.backends import kernel_enabled

        on = kernel_enabled(self.use_kernel, self.n, device=self.dist.device)
        return DSumKernelSweep() if on else None

    def update(self, state: DSumState, j) -> DSumState:
        j = one_index(j, self.dist.device)
        return DSumState(
            selsum=state.selsum + self.dist.index_select(1, j)[:, 0],
            selmask=state.selmask.index_fill(0, j, 1.0),
        )

    def evaluate(self, mask) -> torch.Tensor:
        m = torch.as_tensor(mask, device=self.dist.device).to(torch.float32)
        return 0.5 * (m @ self.dist @ m)

    def evaluate_state(self, state: DSumState) -> torch.Tensor:
        raise NotImplementedError("needs the selection mask; use evaluate().")


# -- DisparityMin --------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class DMinState:
    mind: torch.Tensor  # (n,) min_{k in A} d_jk  (BIG while A is empty)
    curmin: torch.Tensor  # 0-d f(A) (0 while |A| <= 1)
    count: torch.Tensor  # 0-d int32 |A|
    selmask: torch.Tensor  # (n,) fp32 0/1 selection indicator (feeds the stateless sweep)


class DMinKernelSweep:
    """GainBackend: the stateless masked-min sweep recomputing ``mind`` from
    the selection mask (kernels/disp_gains.py); equal to the memoized path
    bit for bit, as the min does not depend on order.  Full sweeps only."""

    name = "cuda-dmin"

    def full_sweep(self, fn: "DisparityMin", state: DMinState) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.dmin_gains(fn.dist, state.selmask, state.count, state.curmin)


@dataclasses.dataclass(frozen=True, eq=False)
class DisparityMin(SetFunction):
    dist: torch.Tensor  # (n, n) pairwise distances
    n: int
    local_gathers = True  # gains_at's value at an index ignores the others
    use_kernel: bool | None = False  # as DisparitySum's

    @staticmethod
    def from_distance(dist, use_kernel: bool | None = False, device=None) -> "DisparityMin":
        """A tensor keeps its device; numpy input goes to ``device`` (default: the card)."""
        dist = as_float_tensor(dist, device).contiguous()
        return DisparityMin(dist=dist, n=int(dist.shape[0]), use_kernel=use_kernel)

    def init_state(self) -> DMinState:
        dev = self.dist.device
        return DMinState(
            mind=torch.full((self.n,), _BIG, dtype=torch.float32, device=dev),
            curmin=torch.zeros((), dtype=torch.float32, device=dev),
            count=torch.zeros((), dtype=torch.int32, device=dev),
            selmask=torch.zeros((self.n,), dtype=torch.float32, device=dev),
        )

    def gains(self, state: DMinState) -> torch.Tensor:
        # the dispersion surrogate (module docstring): farthest-point rule
        return dmin_finish(state.mind, state.count, state.curmin)

    def gains_at(self, state: DMinState, idxs) -> torch.Tensor:
        return dmin_finish(state.mind[idxs.to(self.dist.device)], state.count, state.curmin)

    def gain_backend(self) -> DMinKernelSweep | None:
        from repro_torch.core.optimizers.backends import kernel_enabled

        on = kernel_enabled(self.use_kernel, self.n, device=self.dist.device)
        return DMinKernelSweep() if on else None

    def update(self, state: DMinState, j) -> DMinState:
        j = one_index(j, self.dist.device)
        mind_j = state.mind.gather(0, j).reshape(())
        newmin = torch.where(
            state.count <= 0,
            state.curmin,  # first element: f stays 0
            torch.where(
                state.count == 1,
                mind_j,  # second element: f = the pair distance
                torch.minimum(state.curmin, mind_j),
            ),
        )
        return DMinState(
            mind=torch.minimum(state.mind, self.dist.index_select(1, j)[:, 0]),
            curmin=newmin,
            count=state.count + 1,
            selmask=state.selmask.index_fill(0, j, 1.0),
        )

    def evaluate(self, mask) -> torch.Tensor:
        block = _pair_block(self.dist, mask)
        if block.shape[0] < 2:
            return torch.zeros((), dtype=torch.float32, device=self.dist.device)
        return block.amin()

    def evaluate_state(self, state: DMinState) -> torch.Tensor:
        return state.curmin


# -- DisparityMinSum -----------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class DMinSumState:
    t: torch.Tensor  # (n,): candidates -> min_{k in A} d_jk; selected -> h_i(A)
    selected: torch.Tensor  # (n,) bool
    count: torch.Tensor  # 0-d int32 |A|
    value: torch.Tensor  # 0-d f(A), telescoped gains


@dataclasses.dataclass(frozen=True, eq=False)
class DisparityMinSum(SetFunction):
    dist: torch.Tensor  # (n, n) pairwise distances
    n: int

    @staticmethod
    def from_distance(dist, device=None) -> "DisparityMinSum":
        """A tensor keeps its device; numpy input goes to ``device`` (default: the card)."""
        dist = as_float_tensor(dist, device).contiguous()
        return DisparityMinSum(dist=dist, n=int(dist.shape[0]))

    def init_state(self) -> DMinSumState:
        dev = self.dist.device
        return DMinSumState(
            t=torch.full((self.n,), _BIG, dtype=torch.float32, device=dev),
            selected=torch.zeros((self.n,), dtype=torch.bool, device=dev),
            count=torch.zeros((), dtype=torch.int32, device=dev),
            value=torch.zeros((), dtype=torch.float32, device=dev),
        )

    def _gains(self, state: DMinSumState, cols) -> torch.Tensor:
        """Gains at ``cols`` (None: every candidate)."""
        t = state.t if cols is None else state.t[cols]
        t_cand = torch.clamp(t, max=_BIG)
        # the selected rows whose min shrinks to d_ij (host sync: which rows)
        sel = torch.nonzero(state.selected)[:, 0]
        t_sel = state.t[sel][:, None]
        block = self.dist.index_select(0, sel) if cols is None else self.dist[sel[:, None], cols[None, :]]
        gains = t_cand + (torch.minimum(t_sel, block) - t_sel).sum(dim=0)
        gains = torch.where(state.count == 1, 2.0 * t_cand, gains)
        return torch.where(state.count == 0, 0.0, gains)

    def gains(self, state: DMinSumState) -> torch.Tensor:
        return self._gains(state, None)

    def gains_at(self, state: DMinSumState, idxs) -> torch.Tensor:
        return self._gains(state, idxs.to(self.dist.device))

    def update(self, state: DMinSumState, j) -> DMinSumState:
        j = one_index(j, self.dist.device)
        gain_j = self.gains(state).gather(0, j).reshape(())  # as the JAX package does
        # exclude the self-distance d_jj so j's own statistic stays
        # min_{k in A} d_jk rather than collapsing to zero
        dj = self.dist.index_select(1, j)[:, 0].index_fill(0, j, _BIG)
        # selected rows (the singleton's included) take min with d_ij; the
        # newly added j keeps its candidate statistic min_{k in A} d_jk
        t_sel = torch.where(state.count == 1, dj, torch.minimum(state.t, dj))
        return DMinSumState(
            t=torch.where(state.selected, t_sel, torch.minimum(state.t, dj)),
            selected=state.selected.index_fill(0, j, True),
            count=state.count + 1,
            value=state.value + gain_j,
        )

    def evaluate(self, mask) -> torch.Tensor:
        block = _pair_block(self.dist, mask)
        if block.shape[0] < 2:
            return torch.zeros((), dtype=torch.float32, device=self.dist.device)
        mins = block.amin(dim=1)
        return torch.where(mins < _BIG, mins, 0.0).sum()

    def evaluate_state(self, state: DMinSumState) -> torch.Tensor:
        return state.value


# Every Disparity* empty-set gain is exactly 0, so the library-wide
# stopIfZeroGain=True default would return an empty selection: the family
# defaults to stopIfZeroGain=False (an explicit flag wins), as in the JAX
# package.
for _cls in (DisparitySum, DisparityMin, DisparityMinSum):
    register_family_defaults(_cls, stopIfZeroGain=False)
del _cls
