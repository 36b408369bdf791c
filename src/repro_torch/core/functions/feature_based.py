"""Feature-Based function (paper §2.3.3):

  f(A) = sum_{f in F} w_f * g(m_f(A)),   m_f(A) = sum_{x in A} m_f(x)

with g concave in {sqrt, log, inverse}.  Memoized statistic (Table 3): the
accumulated modular feature vector m_f(A).

``use_kernel=True`` routes sweeps through the CUDA kernels of
``kernels/fb_gains.py`` (full and gathered): one pass over the (n, F)
feature matrix with no (n, F) temporary.  The torch path keeps the JAX
package's form (elementwise multiply, then reduce) and streams it in row
blocks (``common.map_row_blocks``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import as_float_tensor, get_concave, map_row_blocks, one_index
from repro_torch.core.functions.base import SetFunction


@dataclasses.dataclass(frozen=True, eq=False)
class FBState:
    acc: torch.Tensor  # (F,) accumulated feature mass m_f(A)


class FBKernelSweep:
    """GainBackend: the fused add -> concave -> weighted-reduce sweep over
    the feature matrix (kernels/fb_gains.py), full and gathered."""

    name = "cuda-fb"
    local_gathers = True  # the gathered kernel equals the full sweep bit for bit

    def full_sweep(self, fn: "FeatureBased", state: FBState) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.fb_gains(fn.feats, state.acc, fn.w, fn.concave)

    def partial_sweep(self, fn: "FeatureBased", state: FBState, idx: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.fb_gains_at(fn.feats, state.acc, fn.w, idx, fn.concave)


@dataclasses.dataclass(frozen=True, eq=False)
class FeatureBased(SetFunction):
    feats: torch.Tensor  # (n, F) non-negative feature scores
    w: torch.Tensor  # (F,)
    n: int
    local_gathers = True  # gains_at's value at an index ignores the others
    concave: str = "sqrt"
    # True/False routes sweeps through the CUDA kernels / plain torch; None
    # defers to the choose_backend table (backends.py)
    use_kernel: bool | None = False

    @staticmethod
    def from_features(
        feats, w=None, concave: str = "sqrt", use_kernel: bool | None = False, device=None
    ) -> "FeatureBased":
        """Negative scores are clamped to 0.  A tensor keeps its device;
        numpy input goes to ``device`` (default: the card)."""
        get_concave(concave)  # validate
        feats = torch.clamp(as_float_tensor(feats, device), min=0.0).contiguous()
        F = feats.shape[1]
        w = (torch.ones((F,), dtype=torch.float32, device=feats.device) if w is None
             else as_float_tensor(w, feats.device))
        return FeatureBased(feats=feats, w=w, n=int(feats.shape[0]), concave=concave,
                            use_kernel=use_kernel)

    def init_state(self) -> FBState:
        return FBState(acc=torch.zeros((self.feats.shape[1],), dtype=torch.float32,
                                       device=self.feats.device))

    def _gains(self, state: FBState, rows) -> torch.Tensor:
        g = get_concave(self.concave)
        base = g(state.acc)

        def block(x):
            return ((g(state.acc[None, :] + x) - base[None, :]) * self.w[None, :]).sum(dim=-1)

        return map_row_blocks(block, self.feats, rows)

    def gains(self, state: FBState) -> torch.Tensor:
        return self._gains(state, None)

    def gains_at(self, state: FBState, idxs) -> torch.Tensor:
        return self._gains(state, idxs.to(self.feats.device))

    def update(self, state: FBState, j) -> FBState:
        j = one_index(j, self.feats.device)
        return FBState(acc=state.acc + self.feats.index_select(0, j)[0])

    def gain_backend(self) -> FBKernelSweep | None:
        from repro_torch.core.optimizers.backends import kernel_enabled

        on = kernel_enabled(self.use_kernel, self.n, device=self.feats.device)
        return FBKernelSweep() if on else None

    def evaluate(self, mask) -> torch.Tensor:
        m = torch.as_tensor(mask, device=self.feats.device).to(torch.bool)
        acc = torch.where(m[:, None], self.feats, 0.0).sum(dim=0)
        return torch.dot(self.w, get_concave(self.concave)(acc))

    def evaluate_state(self, state: FBState) -> torch.Tensor:
        return torch.dot(self.w, get_concave(self.concave)(state.acc))
