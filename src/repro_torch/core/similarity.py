"""Similarity kernel creation (paper §8 "usage patterns").

Modes
-----
dense      : full (n_rows, n_cols) kernel — the O(n^2 d) hotspot (paper
             Table 5); routed through the hand-written CUDA kernel when
             ``use_pallas=True`` (the name is the JAX package's, kept so
             callers of both packages read the same).
sparse     : fixed top-k neighbour layout — similarity beyond the k nearest
             neighbours is zeroed.

Metrics: ``dot``, ``cosine`` (shifted to [0,1]), ``euclidean`` (similarity
1/(1+d)), ``rbf``.  All produced similarities are non-negative, which the
monotone functions (FL) require.

Numpy (or list) input goes to ``device``, which defaults to the card; a
tensor keeps its device.  Everything is computed in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.common import as_float_tensor
from repro_torch.kernels.similarity_kernel import METRICS, similarity_plain


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xx = torch.sum(x * x, dim=1)[:, None]
    yy = torch.sum(y * y, dim=1)[None, :]
    d2 = xx + yy - 2.0 * (x @ y.T)
    return torch.clamp(d2, min=0.0)


def create_kernel(
    x,
    y=None,
    metric: str = "cosine",
    mode: str = "dense",
    num_neighbors: int | None = None,
    rbf_sigma: float | None = None,
    use_pallas: bool = False,
    device=None,
) -> torch.Tensor:
    """Similarity kernel S of shape (n_x, n_y); ``y`` defaults to ``x``.

    Rows are the *represented* set, columns the ground set, matching the
    paper's U-vs-V distinction.  ``use_pallas=True`` builds S with the CUDA
    kernel (``kernels.ops.similarity``) on a CUDA tensor.
    """
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; choose from {METRICS}")
    x = as_float_tensor(x, device)
    y = x if y is None else as_float_tensor(y, device if device is not None else x.device)

    if use_pallas:
        from repro_torch.kernels import ops

        sim = ops.similarity(x.contiguous(), y.contiguous(), metric=metric, rbf_sigma=rbf_sigma)
    else:
        sim = _reference_kernel(x, y, metric, rbf_sigma)

    if mode == "dense":
        return sim
    if mode == "sparse":
        if num_neighbors is None:
            raise ValueError("sparse mode requires num_neighbors")
        return sparsify_topk(sim, num_neighbors)
    raise ValueError(f"unknown mode {mode!r} (clustered mode is not ported yet)")


def _reference_kernel(x, y, metric, rbf_sigma):
    # the plain version beside the CUDA kernel is the reference
    return similarity_plain(x, y, metric, rbf_sigma)


def sparsify_topk(sim: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest entries per row (incl. self), zero the rest."""
    k = min(k, sim.shape[1])
    thresh = torch.topk(sim, k, dim=1).values[:, -1]
    return torch.where(sim >= thresh[:, None], sim, 0.0)
