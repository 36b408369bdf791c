"""Pairwise similarity: the CUDA kernel's launcher and its plain version.

The kernel (``csrc/similarity.cu``) is the port of
``repro/kernels/similarity_kernel.py::similarity_pallas``: a tiled fp32
SGEMM with the metric epilogue applied in registers before the single store
of each output tile.  As in the JAX wrapper, cosine rows are normalised and
the row sums of squares ``xx`` / ``yy`` are computed here, before the launch.

``similarity_plain`` is the same function in plain PyTorch: what the public
wrapper (``kernels/ops.py``) runs for CPU tensors, and what the kernel is
held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

METRICS = ("dot", "cosine", "euclidean", "rbf")
_METRIC_CODE = {m: i for i, m in enumerate(METRICS)}
_MAX_GRID_Y = 65535  # CUDA's grid.y limit; the kernel tiles rows by 128
_TILE_ROWS = 128


def _sigma(d: int, rbf_sigma: float | None) -> float:
    # the default is sqrt(d) of the caller's (unpadded) feature width
    return float(rbf_sigma) if rbf_sigma is not None else float(d) ** 0.5


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)


def similarity_plain(
    x: torch.Tensor, y: torch.Tensor, metric: str = "dot", rbf_sigma: float | None = None
) -> torch.Tensor:
    """(n, d), (m, d) -> (n, m) fp32 similarity in plain PyTorch.  On the
    card the product must run in full fp32: callers there disable TF32
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    if metric == "dot":
        return x @ y.T
    if metric == "cosine":
        return 0.5 * (1.0 + _normalize(x) @ _normalize(y).T)
    d2 = torch.clamp(
        (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] - 2.0 * (x @ y.T), min=0.0
    )
    if metric == "euclidean":
        return 1.0 / (1.0 + torch.sqrt(d2))
    if metric == "rbf":
        sigma = _sigma(x.shape[1], rbf_sigma)
        return torch.exp(-d2 / (2.0 * sigma * sigma))
    raise ValueError(f"unknown metric {metric!r}; choose from {METRICS}")


def similarity_cuda(
    x: torch.Tensor, y: torch.Tensor, metric: str = "dot", rbf_sigma: float | None = None
) -> torch.Tensor:
    """Launch the CUDA kernel on fp32, contiguous CUDA tensors (checked by
    ``ops.similarity``); returns the (n, m) similarity."""
    n, d = x.shape
    m = y.shape[0]
    if -(-n // _TILE_ROWS) > _MAX_GRID_Y:
        raise ValueError(f"similarity kernel takes at most {_MAX_GRID_Y * _TILE_ROWS} rows, got {n}")
    if metric == "cosine":
        x, y = _normalize(x).contiguous(), _normalize(y).contiguous()
    xx = (x * x).sum(1)
    yy = (y * y).sum(1)
    sigma = _sigma(d, rbf_sigma)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    lib = _build.load()
    rc = lib.similarity_launch(
        x.data_ptr(), y.data_ptr(), xx.data_ptr(), yy.data_ptr(), out.data_ptr(),
        n, m, d, _METRIC_CODE[metric], 1.0 / (2.0 * sigma * sigma),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "similarity kernel")
    return out
