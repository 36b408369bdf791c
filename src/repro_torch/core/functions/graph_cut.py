"""Graph Cut:  f(A) = sum_{i in U, j in A} S_ij - lam * sum_{i,j in A} S_ij
(paper §2.1.2; monotone submodular for lam <= 0.5, non-monotone above).

Memoized statistic (Table 3): ``selsum_j = sum_{k in A} S_jk`` over the
ground-set kernel, plus the static modular vector ``total_j = sum_{i in U}
S_ij``.  The gain is then

  f(j|A) = total_j - lam * (2 * selsum_j + S_jj)

:class:`GraphCutMF` is the matrix-free variant: the ground kernel lives
behind a source (``core/sources.py``) and the memoized statistics
(``total``, ``diag``, incremental ``selsum``) are built by streaming it —
the (n, n) matrix is never written.

Both have a stateless kernel backend that recomputes the whole sweep from
the selection mask: dense GraphCut (and GraphCutMF over a dense source)
streams S through ``kernels/gc_gains.py`` (O(n^2) bytes per call), a
feature source recomputes the selected columns of S through
``kernels/gcmf_gains.py`` (O(n |A| d) operations per call), against the
memoized O(n) ``gains()``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import as_float_tensor, one_index
from repro_torch.core.functions.base import SetFunction
from repro_torch.core.sources import (
    DenseSource,
    FeatureSource,
    dense_source,
    feature_source,
    knn_source,
)


@dataclasses.dataclass(frozen=True, eq=False)
class GCState:
    selsum: torch.Tensor  # (n,) sum_{k in A} S_jk for every ground element j
    value: torch.Tensor  # running f(A), maintained by telescoping gains
    selmask: torch.Tensor  # (n,) fp32 0/1 selection indicator (feeds the stateless sweep)


def _init_state(n: int, device) -> GCState:
    return GCState(
        selsum=torch.zeros((n,), dtype=torch.float32, device=device),
        value=torch.zeros((), dtype=torch.float32, device=device),
        selmask=torch.zeros((n,), dtype=torch.float32, device=device),
    )


def _updated(state: GCState, j: torch.Tensor, col: torch.Tensor, gain_j) -> GCState:
    return GCState(
        selsum=state.selsum + col,
        value=state.value + gain_j.reshape(()),
        selmask=state.selmask.index_fill(0, j, 1.0),
    )


class GCKernelSweep:
    """GainBackend: one pass over the dense ground kernel recomputing the
    sweep from the selection mask (masked row sums + diagonal + combine;
    see kernels/gc_gains.py), full and gathered.  Each call streams all of
    S: it serves one-shot sweeps, while the memoized O(n) ``gains()``
    remains the faster choice inside long greedy loops."""

    name = "cuda-gc"

    @staticmethod
    def _sim(fn) -> torch.Tensor:
        return fn.sim_ground if isinstance(fn, GraphCut) else fn.src.sim

    def full_sweep(self, fn, state: GCState) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.gc_gains(self._sim(fn), state.selmask, fn.total, fn.lam)

    def partial_sweep(self, fn, state: GCState, idx: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.gc_gains_at(self._sim(fn), state.selmask, fn.total, fn.lam, idx)


@dataclasses.dataclass(frozen=True, eq=False)
class GraphCut(SetFunction):
    """Graph Cut over a materialised ground kernel.  ``use_kernel=True``
    routes sweeps through the CUDA kernels (:class:`GCKernelSweep`), None
    defers to the choose_backend table (backends.py)."""

    sim_ground: torch.Tensor  # (n, n) kernel among ground-set elements
    total: torch.Tensor  # (n,) sum_{i in U} S_ij  (modular representation term)
    lam: torch.Tensor  # 0-d trade-off
    n: int
    local_gathers = True  # gains_at's value at an index ignores the others
    use_kernel: bool | None = False

    @staticmethod
    def from_kernel(
        sim_ground,
        lam: float = 0.5,
        sim_rep=None,
        use_kernel: bool | None = False,
        device=None,
    ) -> "GraphCut":
        """``sim_rep`` is the (|U|, n) represented-set kernel; defaults to the
        ground kernel itself (U == V), matching the paper's default.  A
        tensor keeps its device; numpy input goes to ``device`` (default:
        the card)."""
        sim_ground = as_float_tensor(sim_ground, device).contiguous()
        rep = sim_ground if sim_rep is None else as_float_tensor(sim_rep, sim_ground.device)
        return GraphCut(
            sim_ground=sim_ground,
            total=rep.sum(dim=0),
            lam=torch.tensor(float(lam), dtype=torch.float32, device=sim_ground.device),
            n=int(sim_ground.shape[0]),
            use_kernel=use_kernel,
        )

    def init_state(self) -> GCState:
        return _init_state(self.n, self.sim_ground.device)

    def gains(self, state: GCState) -> torch.Tensor:
        diag = torch.diagonal(self.sim_ground)
        return self.total - self.lam * (2.0 * state.selsum + diag)

    def gains_at(self, state: GCState, idxs) -> torch.Tensor:
        idxs = idxs.to(self.sim_ground.device)
        diag = self.sim_ground[idxs, idxs]
        return self.total[idxs] - self.lam * (2.0 * state.selsum[idxs] + diag)

    def update(self, state: GCState, j) -> GCState:
        j = one_index(j, self.sim_ground.device)
        col = self.sim_ground.index_select(1, j)[:, 0]
        return _updated(state, j, col, self.gains_at(state, j))

    def gain_backend(self) -> GCKernelSweep | None:
        from repro_torch.core.optimizers.backends import kernel_enabled

        on = kernel_enabled(self.use_kernel, self.n, device=self.sim_ground.device)
        return GCKernelSweep() if on else None

    def evaluate(self, mask) -> torch.Tensor:
        m = torch.as_tensor(mask, device=self.sim_ground.device).to(torch.float32)
        return self.total @ m - self.lam * (m @ self.sim_ground @ m)

    def evaluate_state(self, state: GCState) -> torch.Tensor:
        return state.value


class GCMFKernelSweep:
    """GainBackend: the stateless matrix-free CUDA sweep, similarity computed
    in-stream from the features (kernels/gcmf_gains.py).  Each call costs
    O(n |A| d): it serves one-shot sweeps, while the memoized O(n) ``gains()``
    remains the faster choice inside long greedy loops."""

    name = "cuda-gcmf"

    def full_sweep(self, fn: "GraphCutMF", state: GCState) -> torch.Tensor:
        from repro_torch.kernels import ops

        src = fn.src
        return ops.gcmf_gains(
            src.y, src.yy, state.selmask, fn.total, fn.diag, fn.lam, src.metric, src.rbf_sigma
        )

    def partial_sweep(self, fn: "GraphCutMF", state: GCState, idx: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ops

        src = fn.src
        return ops.gcmf_gains_at(
            src.y, src.yy, state.selmask, fn.total, fn.diag, fn.lam, idx,
            src.metric, src.rbf_sigma,
        )


@dataclasses.dataclass(frozen=True, eq=False)
class GraphCutMF(SetFunction):
    """Matrix-free Graph Cut: same objective and memoized statistics as
    :class:`GraphCut`, with the ground kernel behind a source.  ``total``
    and ``diag`` are computed at build time by streaming the source (O(n d)
    memory); each update streams one similarity column.

    ``use_kernel=True`` routes unlabelled feature sources through the
    matrix-free CUDA sweep and dense sources through the dense one (as the
    JAX package does); ``None`` picks them by the choose_backend table.
    Clustered sources stay on the torch path."""

    src: object  # square FeatureSource | DenseSource | KnnSource over the ground set
    total: torch.Tensor  # (n,) sum_{i in U} S_ij
    diag: torch.Tensor  # (n,) S_jj
    lam: torch.Tensor  # 0-d trade-off
    n: int
    use_kernel: bool | None = False

    @staticmethod
    def from_features(
        x,
        lam: float = 0.5,
        metric: str = "dot",
        rbf_sigma: float | None = None,
        labels=None,
        use_kernel: bool | None = False,
        device=None,
    ) -> "GraphCutMF":
        src = feature_source(x, metric=metric, rbf_sigma=rbf_sigma, labels=labels, device=device)
        return GraphCutMF._from_source(src, lam, use_kernel)

    @staticmethod
    def from_knn(
        indices, weights, lam: float = 0.5, use_kernel: bool | None = False, device=None
    ) -> "GraphCutMF":
        """Graph Cut over a square sparse k-NN similarity (torch path only,
        as in the JAX package)."""
        return GraphCutMF._from_source(knn_source(indices, weights, device=device), lam, use_kernel)

    @staticmethod
    def from_dense(
        sim, lam: float = 0.5, use_kernel: bool | None = False, device=None
    ) -> "GraphCutMF":
        return GraphCutMF._from_source(dense_source(sim, device), lam, use_kernel)

    @staticmethod
    def _from_source(src, lam, use_kernel) -> "GraphCutMF":
        if src.n_rows != src.n_cols:
            raise ValueError(
                f"GraphCutMF needs a square ground-set source; got ({src.n_rows}, {src.n_cols})"
            )
        return GraphCutMF(
            src=src,
            total=src.col_sums(),
            diag=src.diag(),
            lam=torch.tensor(float(lam), dtype=torch.float32, device=src.device),
            n=src.n_cols,
            use_kernel=use_kernel,
        )

    def init_state(self) -> GCState:
        return _init_state(self.n, self.src.device)

    def gains(self, state: GCState) -> torch.Tensor:
        return self.total - self.lam * (2.0 * state.selsum + self.diag)

    def gains_at(self, state: GCState, idxs) -> torch.Tensor:
        idxs = idxs.to(self.src.device)
        return self.total[idxs] - self.lam * (2.0 * state.selsum[idxs] + self.diag[idxs])

    def update(self, state: GCState, j) -> GCState:
        j = one_index(j, self.src.device)
        return _updated(state, j, self.src.col(j), self.gains_at(state, j))

    def gain_backend(self) -> GCMFKernelSweep | GCKernelSweep | None:
        from repro_torch.core.optimizers.backends import kernel_enabled

        if not kernel_enabled(self.use_kernel, self.n, matrix_free=True, device=self.src.device):
            return None
        if isinstance(self.src, DenseSource):
            return GCKernelSweep()
        if isinstance(self.src, FeatureSource) and self.src.col_labels is None:
            return GCMFKernelSweep()
        return None  # k-NN and clustered sources stay on the torch path

    def evaluate(self, mask) -> torch.Tensor:
        m = torch.as_tensor(mask, device=self.src.device).to(torch.float32)
        return self.total @ m - self.lam * self.src.quad(m)

    def evaluate_state(self, state: GCState) -> torch.Tensor:
        return state.value
