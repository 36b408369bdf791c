"""Facility Location:  f(A) = sum_{i in U} max_{j in A} S_ij   (paper §2.1.1).

U is the *represented* set (rows of S) which may differ from the ground set V
(columns of S).  Memoized statistic (paper Table 3): ``curmax_i = max_{j in A}
S_ij`` for every i in U; with it a gain query is one fused relu-reduction,
evaluated for ALL candidates at once.

The per-step gain sweeps are the hotspot.  With the kernel backend
(``use_kernel=True``, or None with a large n on the card) they run through
the hand-written CUDA sweep in ``repro_torch/kernels/fl_gains.py``, in its
full and its gathered-subset form.

:class:`FacilityLocationMF` is the matrix-free variant: sim(i, j) is
answered on demand by a source (``core/sources.py``), and its kernel
backend runs the fused similarity + sweep of ``kernels/flmf_gains.py``.

Both kernel backends sweep a batched engine's wave of dense members in one
launch (``full_sweep_wave`` / ``partial_sweep_wave``): the members' S are
views of the engine's one stacked tensor, read as a (B, u, n) wave.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import (
    as_float_tensor,
    one_index,
    relu_col_sums,
    row_sums_fixed,
    stacked_view,
)
from repro_torch.core.functions.base import SetFunction
from repro_torch.core.sources import (
    DenseSource,
    FeatureSource,
    dense_source,
    feature_source,
    knn_source,
)


@dataclasses.dataclass(frozen=True, eq=False)
class FLState:
    curmax: torch.Tensor  # (n_rows,) max similarity of each represented point to A
    n_rows: int


class FLKernelSweep:
    """GainBackend: the CUDA relu-reduce sweep over the similarity matrix
    (full and gathered-subset entry points; see kernels/fl_gains.py)."""

    name = "cuda-fl"
    local_gathers = True  # the gathered kernel equals the full sweep bit for bit

    def full_sweep(self, fn: "FacilityLocation", state: FLState) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.fl_gains(fn.sim, state.curmax)

    def partial_sweep(
        self, fn: "FacilityLocation", state: FLState, idx: torch.Tensor
    ) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.fl_gains_at(fn.sim, state.curmax, idx)

    def full_sweep_wave(self, fns, states) -> torch.Tensor | None:
        return _fl_wave([f.sim for f in fns], states, None)

    def partial_sweep_wave(self, fns, states, idx: torch.Tensor) -> torch.Tensor | None:
        return _fl_wave([f.sim for f in fns], states, idx)


def _fl_wave(sims, states, idx) -> torch.Tensor | None:
    """One ``fl_gains`` (idx None) or ``fl_gains_at`` launch for a wave
    whose S are members of one stacked tensor; None (one launch per member)
    when they are not.  Only the (B, u) curmax is stacked, never S."""
    from repro_torch.kernels import ops

    sim = stacked_view(sims)
    if sim is None:
        return None
    curmax = torch.stack([s.curmax for s in states])
    return ops.fl_gains(sim, curmax) if idx is None else ops.fl_gains_at(sim, curmax, idx)


@dataclasses.dataclass(frozen=True, eq=False)
class FacilityLocation(SetFunction):
    sim: torch.Tensor  # (|U|, n) similarity, rows = represented set, cols = ground set
    n: int
    # True/False routes the gain sweeps through the CUDA kernel / plain torch;
    # None defers to the choose_backend heuristic (backends.py)
    use_kernel: bool | None = False
    local_gathers = True  # gains_at's value at an index ignores the others

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
        # each column in row_sums_fixed's order: torch.sum's follows the
        # column count, and a mesh shard holds a slice of the columns
        return row_sums_fixed(torch.clamp(self.sim - state.curmax[:, None], min=0.0))

    def gain_backend(self) -> FLKernelSweep | None:
        from repro_torch.core.optimizers.backends import kernel_enabled

        on = kernel_enabled(self.use_kernel, self.n, device=self.sim.device)
        return FLKernelSweep() if on else None

    def gains_at(self, state: FLState, idxs) -> torch.Tensor:
        # each column in a fixed order of its own: a gathered sweep's value
        # at an index does not depend on the other indices swept with it
        # (the streaming optimizers' windows rely on it)
        return relu_col_sums(self.sim, state.curmax, idxs)

    def update(self, state: FLState, j) -> FLState:
        col = self.sim.index_select(1, one_index(j, self.sim.device))[:, 0]
        return FLState(curmax=torch.maximum(state.curmax, col), n_rows=state.n_rows)

    def evaluate(self, mask) -> torch.Tensor:
        mask = torch.as_tensor(mask, dtype=torch.bool).to(self.sim.device)
        masked = torch.where(mask[None, :], self.sim, 0.0)
        # max over an empty set is 0 (jnp.max(..., initial=0.0) in the JAX package)
        best = torch.clamp(masked.amax(dim=1), min=0.0)
        return best.sum()

    def evaluate_state(self, state: FLState) -> torch.Tensor:
        return state.curmax.sum()


class FLMFKernelSweep:
    """GainBackend: the matrix-free CUDA sweep, similarity computed in-stream
    from the features (kernels/flmf_gains.py); dense sources reuse the
    materialised-matrix kernel (kernels/fl_gains.py)."""

    name = "cuda-flmf"
    local_gathers = True  # the gathered kernel equals the full sweep bit for bit

    def full_sweep(self, fn: "FacilityLocationMF", state: FLState) -> torch.Tensor:
        from repro_torch.kernels import ops

        src = fn.src
        if isinstance(src, DenseSource):
            return ops.fl_gains(src.sim, state.curmax)
        return ops.flmf_gains(
            src.x, src.y, src.xx, src.yy, state.curmax, src.metric, src.rbf_sigma
        )

    def partial_sweep(
        self, fn: "FacilityLocationMF", state: FLState, idx: torch.Tensor
    ) -> torch.Tensor:
        from repro_torch.kernels import ops

        src = fn.src
        if isinstance(src, DenseSource):
            return ops.fl_gains_at(src.sim, state.curmax, idx)
        return ops.flmf_gains_at(
            src.x, src.y, src.xx, src.yy, state.curmax, idx, src.metric, src.rbf_sigma
        )

    # a wave of dense sources rides the dense kernel's member axis; the
    # feature-source kernels take one member per launch (None: decline)
    def full_sweep_wave(self, fns, states) -> torch.Tensor | None:
        if not all(isinstance(f.src, DenseSource) for f in fns):
            return None
        return _fl_wave([f.src.sim for f in fns], states, None)

    def partial_sweep_wave(self, fns, states, idx: torch.Tensor) -> torch.Tensor | None:
        if not all(isinstance(f.src, DenseSource) for f in fns):
            return None
        return _fl_wave([f.src.sim for f in fns], states, idx)


@dataclasses.dataclass(frozen=True, eq=False)
class FacilityLocationMF(SetFunction):
    """Matrix-free Facility Location: same objective and memoized statistic
    as :class:`FacilityLocation`, but sim(i, j) is answered on demand by a
    source (:class:`~repro_torch.core.sources.FeatureSource` or
    :class:`~repro_torch.core.sources.DenseSource`), so the (|U|, n) matrix
    is never written and peak memory is O(n * d) feature bytes."""

    src: object  # FeatureSource | DenseSource | KnnSource
    n: int
    local_gathers = True  # gains_at's value at an index ignores the others
    # True/False routes the sweeps through the CUDA kernels / plain torch;
    # None defers to the choose_backend heuristic (backends.py).  Clustered
    # (labelled) sources always take the torch path.
    use_kernel: bool | None = False

    @staticmethod
    def from_features(
        x,
        y=None,
        metric: str = "dot",
        rbf_sigma: float | None = None,
        labels=None,
        use_kernel: bool | None = False,
        device=None,
    ) -> "FacilityLocationMF":
        """FL over features + metric.  ``y`` is the candidate (column) side
        and defaults to ``x`` itself; ``labels`` switches on the clustered
        block-masked similarity (paper §8), streamed.  A tensor keeps its
        device; numpy input goes to ``device`` (default: the card)."""
        src = feature_source(x, y, metric=metric, rbf_sigma=rbf_sigma, labels=labels, device=device)
        return FacilityLocationMF(src=src, n=src.n_cols, use_kernel=use_kernel)

    @staticmethod
    def from_knn(
        indices, weights, n_cols: int | None = None, use_kernel: bool | None = False,
        device=None,
    ) -> "FacilityLocationMF":
        """FL over precomputed sparse k-NN similarity: indices (n, k) int
        with -1 pads, nonnegative weights (n, k).  Its sweeps run on torch
        ops (the JAX package has no kernel for them either), whatever
        ``use_kernel`` says.  Tensors keep their device; numpy input goes to
        ``device`` (default: the card)."""
        src = knn_source(indices, weights, n_cols=n_cols, device=device)
        return FacilityLocationMF(src=src, n=src.n_cols, use_kernel=use_kernel)

    @staticmethod
    def from_dense(sim, use_kernel: bool | None = False, device=None) -> "FacilityLocationMF":
        """Dense matrix riding the matrix-free contract (interop/testing)."""
        src = dense_source(sim, device)
        return FacilityLocationMF(src=src, n=src.n_cols, use_kernel=use_kernel)

    def init_state(self) -> FLState:
        return FLState(
            curmax=torch.zeros((self.src.n_rows,), dtype=torch.float32, device=self.src.device),
            n_rows=self.src.n_rows,
        )

    def gains(self, state: FLState) -> torch.Tensor:
        return self.src.fl_gains(state.curmax)

    def gains_at(self, state: FLState, idxs) -> torch.Tensor:
        return self.src.fl_gains_at(state.curmax, idxs)

    def gain_backend(self) -> FLMFKernelSweep | None:
        from repro_torch.core.optimizers.backends import kernel_enabled

        if not kernel_enabled(self.use_kernel, self.n, matrix_free=True, device=self.src.device):
            return None
        src = self.src
        if isinstance(src, FeatureSource) and src.col_labels is None:
            return FLMFKernelSweep()
        if isinstance(src, DenseSource):
            return FLMFKernelSweep()
        return None  # k-NN and clustered sources stay on the torch path

    def update(self, state: FLState, j) -> FLState:
        return FLState(curmax=torch.maximum(state.curmax, self.src.col(j)), n_rows=state.n_rows)

    def evaluate(self, mask) -> torch.Tensor:
        return self.src.masked_rowmax(mask).sum()

    def evaluate_state(self, state: FLState) -> torch.Tensor:
        return state.curmax.sum()
