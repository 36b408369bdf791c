"""Set Cover and Probabilistic Set Cover (paper §2.3.1-2.3.2).

SC:   f(A) = sum_u w_u * min(c_u(A), 1)     with cover matrix G (n, m) in {0,1}
PSC:  f(A) = sum_u w_u * (1 - prod_{j in A} (1 - p_ju))

Memoized statistics (Table 3): the covered-concept indicator for SC and the
per-concept miss probability  Pbar_u = prod_{j in A}(1 - p_ju)  for PSC.

``use_kernel=True`` routes full sweeps through the CUDA kernels of
``kernels/sc_gains.py`` (one pass over the (n, m) matrix each, no (n, m)
temporary); they have no gathered form, so the lazy engine's levels take
``gains_at``, as in the JAX package.  The torch paths keep the JAX
package's form (elementwise multiply, then reduce) and stream it in row
blocks (``common.map_row_blocks``).

ProbabilisticSetCover keeps ``log_miss = log1p(-p)`` (for the products of
``update`` and ``evaluate``) and, unlike the JAX package, ``probs = 1 -
exp(log_miss)`` too: the JAX package forms that (n, m) array anew on every
sweep, the port forms it once at construction with the same expression.
That holds a second (n, m) matrix resident (4.19 GB at n = 2^20, m =
1,000) in place of an (n, m) temporary written and read on every sweep.

The MI / CG / CMI measures of both (paper §5.2.2-5.2.4) are reweighted
instances of these classes, in ``core/info/sc.py``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import as_float_tensor, map_row_blocks, one_index
from repro_torch.core.functions.base import SetFunction


def _weights(w, m: int, device) -> torch.Tensor:
    if w is None:
        return torch.ones((m,), dtype=torch.float32, device=device)
    return as_float_tensor(w, device)


# -- SetCover -------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class SCState:
    covered: torch.Tensor  # (m,) float indicator in [0, 1] of covered concepts


class SCKernelSweep:
    """GainBackend: the fused mask -> weight -> reduce sweep over the
    incidence matrix (kernels/sc_gains.py); full sweeps only."""

    name = "cuda-sc"

    def full_sweep(self, fn: "SetCover", state: SCState) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.sc_gains(fn.cover, state.covered, fn.w)


@dataclasses.dataclass(frozen=True, eq=False)
class SetCover(SetFunction):
    cover: torch.Tensor  # (n, m) binary: element i covers concept u
    w: torch.Tensor  # (m,) concept weights
    n: int
    local_gathers = True  # gains_at's value at an index ignores the others
    # True/False routes full sweeps through the CUDA kernel / plain torch;
    # None defers to the choose_backend table (backends.py)
    use_kernel: bool | None = False

    @staticmethod
    def from_cover(cover, w=None, use_kernel: bool | None = False, device=None) -> "SetCover":
        """A tensor keeps its device; numpy input goes to ``device`` (default: the card)."""
        cover = as_float_tensor(cover, device).contiguous()
        return SetCover(cover=cover, w=_weights(w, cover.shape[1], cover.device),
                        n=int(cover.shape[0]), use_kernel=use_kernel)

    def init_state(self) -> SCState:
        return SCState(covered=torch.zeros((self.cover.shape[1],), dtype=torch.float32,
                                           device=self.cover.device))

    def _gains(self, state: SCState, rows) -> torch.Tensor:
        def block(c):
            return (torch.clamp(c - state.covered[None, :], min=0.0) * self.w[None, :]).sum(dim=-1)

        return map_row_blocks(block, self.cover, rows)

    def gains(self, state: SCState) -> torch.Tensor:
        return self._gains(state, None)

    def gains_at(self, state: SCState, idxs) -> torch.Tensor:
        return self._gains(state, idxs.to(self.cover.device))

    def gain_backend(self) -> SCKernelSweep | None:
        from repro_torch.core.optimizers.backends import kernel_enabled

        on = kernel_enabled(self.use_kernel, self.n, device=self.cover.device)
        return SCKernelSweep() if on else None

    def update(self, state: SCState, j) -> SCState:
        j = one_index(j, self.cover.device)
        return SCState(covered=torch.maximum(state.covered, self.cover.index_select(0, j)[0]))

    def evaluate(self, mask) -> torch.Tensor:
        m = torch.as_tensor(mask, device=self.cover.device).to(torch.bool)
        cov = torch.clamp(torch.where(m[:, None], self.cover, 0.0).amax(dim=0), min=0.0)
        return torch.dot(cov, self.w)

    def evaluate_state(self, state: SCState) -> torch.Tensor:
        return torch.dot(state.covered, self.w)


# -- ProbabilisticSetCover --------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class PSCState:
    miss: torch.Tensor  # (m,) Pbar_u(A) = prod_{j in A} (1 - p_ju)


class PSCKernelSweep:
    """GainBackend: the fused probability-product sweep, each concept
    weighted by the memoized miss probability (kernels/sc_gains.py); full
    sweeps only."""

    name = "cuda-psc"

    def full_sweep(self, fn: "ProbabilisticSetCover", state: PSCState) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.psc_gains(fn.probs, state.miss, fn.w)


def probs_of(log_miss: torch.Tensor) -> torch.Tensor:
    """``1 - exp(log_miss)``, the JAX package's expression, formed in place
    in one new (n, m) tensor: ``-e + 1`` rounds as ``1 - e``."""
    return torch.exp(log_miss).neg_().add_(1.0)


@dataclasses.dataclass(frozen=True, eq=False)
class ProbabilisticSetCover(SetFunction):
    log_miss: torch.Tensor  # (n, m) log(1 - p_ju), for stable products
    probs: torch.Tensor  # (n, m) 1 - exp(log_miss), formed once (module docstring)
    w: torch.Tensor  # (m,)
    n: int
    local_gathers = True  # gains_at's value at an index ignores the others
    use_kernel: bool | None = False  # as SetCover's

    @staticmethod
    def from_probs(
        probs, w=None, use_kernel: bool | None = False, device=None
    ) -> "ProbabilisticSetCover":
        """Probabilities are clipped to [0, 1 - 1e-7].  A tensor keeps its
        device; numpy input goes to ``device`` (default: the card)."""
        # clamp makes a new tensor; negation and log1p then run in place on
        # it, so construction holds one (n, m) temporary less
        log_miss = torch.clamp(as_float_tensor(probs, device), 0.0, 1.0 - 1e-7)
        log_miss.neg_().log1p_()
        return ProbabilisticSetCover(
            log_miss=log_miss, probs=probs_of(log_miss),
            w=_weights(w, log_miss.shape[1], log_miss.device),
            n=int(log_miss.shape[0]), use_kernel=use_kernel,
        )

    def init_state(self) -> PSCState:
        return PSCState(miss=torch.ones((self.log_miss.shape[1],), dtype=torch.float32,
                                        device=self.log_miss.device))

    def _gains(self, state: PSCState, rows) -> torch.Tensor:
        # f(j|A) = sum_u w_u * Pbar_u(A) * p_ju
        wm = (self.w * state.miss)[None, :]
        return map_row_blocks(lambda p: (p * wm).sum(dim=-1), self.probs, rows)

    def gains(self, state: PSCState) -> torch.Tensor:
        return self._gains(state, None)

    def gains_at(self, state: PSCState, idxs) -> torch.Tensor:
        return self._gains(state, idxs.to(self.probs.device))

    def gain_backend(self) -> PSCKernelSweep | None:
        from repro_torch.core.optimizers.backends import kernel_enabled

        on = kernel_enabled(self.use_kernel, self.n, device=self.probs.device)
        return PSCKernelSweep() if on else None

    def update(self, state: PSCState, j) -> PSCState:
        j = one_index(j, self.log_miss.device)
        return PSCState(miss=state.miss * torch.exp(self.log_miss.index_select(0, j)[0]))

    def evaluate(self, mask) -> torch.Tensor:
        m = torch.as_tensor(mask, device=self.log_miss.device).to(torch.bool)
        logm = torch.where(m[:, None], self.log_miss, 0.0).sum(dim=0)
        return torch.dot(self.w, 1.0 - torch.exp(logm))

    def evaluate_state(self, state: PSCState) -> torch.Tensor:
        return torch.dot(self.w, 1.0 - state.miss)
