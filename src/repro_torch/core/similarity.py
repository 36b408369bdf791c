"""Similarity kernel creation (paper §8 "usage patterns").

Modes
-----
dense      : full (n_rows, n_cols) kernel — the O(n^2 d) hotspot (paper
             Table 5); routed through the hand-written CUDA kernel when
             ``use_pallas=True`` (the name is the JAX package's, kept so
             callers of both packages read the same).
sparse     : fixed top-k neighbour layout — similarity beyond the k nearest
             neighbours is zeroed.
clustered  : see core/functions/clustered.py (labels from :func:`kmeans` or
             the caller).

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
    raise ValueError(f"unknown mode {mode!r} (clustered mode lives in core/functions/clustered.py)")


def _reference_kernel(x, y, metric, rbf_sigma):
    # the plain version beside the CUDA kernel is the reference
    return similarity_plain(x, y, metric, rbf_sigma)


def sparsify_topk(sim: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest entries per row (incl. self), zero the rest."""
    k = min(k, sim.shape[1])
    thresh = torch.topk(sim, k, dim=1).values[:, -1]
    return torch.where(sim >= thresh[:, None], sim, 0.0)


def kmeans(x, k: int, iters: int = 25, generator: torch.Generator | None = None,
           device=None) -> torch.Tensor:
    """Small k-means (labels only) for the internal-clustering option.

    The initial centroids are ``k`` distinct rows drawn with ``generator``
    (default: a generator on ``x``'s device seeded with 0).  torch's random
    numbers are not ``jax.random``'s, so the draw differs from the JAX
    package's; the iteration is the same (Lloyd steps with one-hot means,
    an empty cluster's centroid going to 0, ties to the first centroid).
    Returns (n,) int64 labels on ``x``'s device."""
    x = as_float_tensor(x, device)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    cents = x[torch.randperm(x.shape[0], generator=generator, device=x.device)[:k]]
    for _ in range(iters):
        lab = torch.argmin(pairwise_sq_dists(x, cents), dim=1)  # first index on ties
        one = torch.nn.functional.one_hot(lab, k).to(x.dtype)
        counts = torch.clamp(one.sum(dim=0)[:, None], min=1.0)
        cents = (one.T @ x) / counts
    return torch.argmin(pairwise_sq_dists(x, cents), dim=1)


def build_extended_kernel(ground, query=None, private=None, metric: str = "cosine",
                          eta: float = 1.0, nu: float = 1.0, device=None):
    """Kernel over V ∪ Q ∪ P with η/ν cross-block scaling (paper §3.4).

    Returns (kernel, q_idx, p_idx); V occupies indices [0, n_v).
    Cross-similarity V<->Q is scaled by η and V<->P by ν, exactly the
    S^{η,ν} construction used by the LogDet information measures.  Numpy
    input goes to ``device`` (default: the card); the index vectors are
    int64 tensors on the kernel's device."""
    parts = [as_float_tensor(ground, device)]
    dev = parts[0].device
    n_v = parts[0].shape[0]
    q_idx = torch.arange(0, device=dev)
    p_idx = torch.arange(0, device=dev)
    if query is not None:
        parts.append(as_float_tensor(query, dev))
        q_idx = torch.arange(n_v, n_v + parts[-1].shape[0], device=dev)
    if private is not None:
        parts.append(as_float_tensor(private, dev))
        start = n_v + (0 if query is None else q_idx.shape[0])
        p_idx = torch.arange(start, start + parts[-1].shape[0], device=dev)
    allpts = torch.cat(parts, dim=0)
    S_base = create_kernel(allpts, metric=metric)
    scale = torch.ones((allpts.shape[0],), device=dev)
    if query is not None:
        scale[q_idx] = eta ** 0.5 if eta >= 0 else 1.0
    if private is not None:
        scale[p_idx] = nu ** 0.5 if nu >= 0 else 1.0
    # symmetric scaling keeps PSD-ness for LogDet: S' = D S D with D diagonal
    S = S_base * scale[:, None] * scale[None, :]
    # restore untouched diagonal blocks (V-V, Q-Q, P-P keep base similarity)
    grp = torch.zeros((allpts.shape[0],), dtype=torch.int32, device=dev)
    grp[q_idx] = 1
    grp[p_idx] = 2
    same = grp[:, None] == grp[None, :]
    return torch.where(same, S_base, S), q_idx, p_idx
