"""Clustered mixtures (paper §8):  f(A) = sum_l f_{C_l}(A ∩ C_l).

For kernel-based functions (FL, GC, LogDet, Disparity*) the mixture over a
hard clustering is exactly the base function evaluated on the *block-masked*
kernel S'_ij = S_ij * [cluster(i) == cluster(j)]: cross-cluster interactions
vanish, so every memoized statistic decomposes per-cluster for free (and for
LogDet the masked kernel is block-diagonal, whose determinant is the product
of per-cluster determinants).  The dense clustered FL and GC therefore run
on the same CUDA sweeps as the dense mode (``fl_gains``, ``fl_gains_at``,
``gc_gains``, ``gc_gains_at``), on the masked S.

Memory: the dense form writes the (n, n) fp32 mask and the masked kernel
beside S, as the JAX package does (30 GB at n = 50,000 before the mask is
dropped).  The matrix-free form writes neither.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.common import as_float_tensor


def cluster_mask(labels, device=None) -> torch.Tensor:
    """(n,) integer labels -> (n, n) fp32 block indicator [label_i ==
    label_j].  A tensor keeps its device unless ``device`` names another;
    numpy goes to ``device`` (default: the CPU, as ``torch.as_tensor``)."""
    labels = torch.as_tensor(labels, device=device)
    return (labels[:, None] == labels[None, :]).to(torch.float32)


def clustered(base_from_kernel: Callable, kernel, labels, **kwargs):
    """Build a clustered mixture of a kernel-based function.

    ``base_from_kernel`` is a ``from_kernel``/``from_distance`` constructor;
    ``labels`` is an (n,) int cluster assignment (user-provided, e.g. from
    supervised classes, or produced by :func:`repro_torch.core.similarity.kmeans`).
    A tensor ``kernel`` keeps its device; numpy goes to ``kwargs["device"]``
    (default: the card)."""
    kernel = as_float_tensor(kernel, kwargs.get("device"))
    return base_from_kernel(kernel * cluster_mask(labels, kernel.device), **kwargs)


def clustered_matrix_free(base_from_features: Callable, x, labels, **kwargs):
    """Matrix-free clustered mixture: neither the kernel NOR the block mask
    is ever materialized.

    ``base_from_features`` is a matrix-free constructor taking a ``labels``
    keyword (``FacilityLocationMF.from_features`` /
    ``GraphCutMF.from_features``); the labels ride the
    :class:`~repro_torch.core.sources.FeatureSource` and zero cross-cluster
    similarity inside the streamed tile sweep (the torch path: labelled
    sources have no kernel backend, as in the JAX package)."""
    if not isinstance(labels, torch.Tensor):
        labels = torch.as_tensor(labels)
    return base_from_features(x, labels=labels.to(torch.int32), **kwargs)
