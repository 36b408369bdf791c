"""Pairwise similarity: the CUDA kernel's launcher and its plain version.

The kernel (``csrc/similarity.cu``) is the port of
``repro/kernels/similarity_kernel.py::similarity_pallas``: a tiled fp32
SGEMM on the pipelined mainloop of ``csrc/sgemm_pipe.cuh``, with the metric
epilogue applied in registers before the single store of each output tile.
As in the JAX wrapper, cosine rows are normalised and the row sums of
squares ``xx`` / ``yy`` are computed here, before the launch.

``similarity_plain`` is the same function in plain PyTorch: what the public
wrapper (``kernels/ops.py``) runs for CPU tensors, and what the kernel is
held against on the card.  :func:`similarity_tiles` streams the same
similarity in fixed-width column blocks, for the matrix-free torch paths.
"""
from __future__ import annotations

import torch

from repro_torch.common import pad_rows, row_sums_fixed
from repro_torch.kernels import _build

METRICS = ("dot", "cosine", "euclidean", "rbf")
# Column-tile width of the streamed matrix-free sweeps (the JAX package's
# sources.py:55).  Fixed, so every similarity block is a matmul of one shape.
TILE = 512
_METRIC_CODE = {m: i for i, m in enumerate(METRICS)}


def _sigma(d: int, rbf_sigma: float | None) -> float:
    # the default is sqrt(d) of the caller's (unpadded) feature width
    return float(rbf_sigma) if rbf_sigma is not None else float(d) ** 0.5


def row_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """(r, d) -> (r,) sums of squares, each row's in an order set by d
    alone (``common.row_sums_fixed`` over the columns), so a row's bits do
    not depend on how many rows ride with it: a session that feeds rows in
    deltas of any size builds the same source as one build of the stream."""
    return row_sums_fixed((x * x).t())


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.sqrt(row_sq_norms(x))[:, None], min=1e-12)


def inv_two_sigma_sq(d: int, rbf_sigma: float | None) -> float:
    """1 / (2 sigma^2) of the rbf epilogue; sigma defaults to sqrt(d)."""
    sigma = _sigma(d, rbf_sigma)
    return 1.0 / (2.0 * sigma * sigma)


def metric_epilogue(
    acc: torch.Tensor, xx: torch.Tensor, yy: torch.Tensor, metric: str, inv2s2: float
) -> torch.Tensor:
    """Similarity block from raw dot products ``acc`` (r, c), as the CUDA
    kernels' epilogue computes it: rows arrive pre-normalised for cosine;
    ``xx`` (r,) / ``yy`` (c,) are the rows' sums of squares, read by
    euclidean and rbf."""
    if metric == "dot":
        return acc
    if metric == "cosine":
        return 0.5 * (1.0 + acc)
    d2 = torch.clamp(xx[:, None] + yy[None, :] - 2.0 * acc, min=0.0)
    if metric == "euclidean":
        return 1.0 / (1.0 + torch.sqrt(d2))
    if metric == "rbf":
        return torch.exp(-d2 * inv2s2)
    raise ValueError(f"unknown metric {metric!r}; choose from {METRICS}")


def similarity_tiles(x, xx, y, yy, metric: str, inv2s2: float):
    """Yield (lo, w, block): metric(x_i, y_c) for the columns c = lo .. lo +
    w - 1 as an (rows, TILE) block, one matmul against exactly TILE rows of
    ``y`` (the last tile zero-padded; its columns past w are padding).  A
    matmul of one fixed shape computes each column independently of its
    position, so a sweep over a gathered ``y`` equals the full sweep bit for
    bit at the same row.  Peak live bytes: one block, never (rows, len(y))."""
    for lo in range(0, y.shape[0], TILE):
        w = min(TILE, y.shape[0] - lo)
        yt, yyt = pad_rows(y[lo : lo + w], TILE), pad_rows(yy[lo : lo + w], TILE)
        yield lo, w, metric_epilogue(x @ yt.T, xx, yyt, metric, inv2s2)


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
    if metric == "cosine":
        x, y = _normalize(x).contiguous(), _normalize(y).contiguous()
    return launch_rows(x, y, metric, inv_two_sigma_sq(x.shape[1], rbf_sigma))


def launch_rows(x: torch.Tensor, y: torch.Tensor, metric: str, inv2s2: float) -> torch.Tensor:
    """The kernel on the rows exactly as given: no normalisation (cosine
    rows come pre-normalised), xx / yy from fresh products, so their bits
    do not depend on where the rows lie in memory.  The launcher copies rows
    16 bytes at a time where every row is 16-byte aligned, else element by
    element, with the same bits."""
    n, d = x.shape
    m = y.shape[0]
    xx = (x * x).sum(1)
    yy = (y * y).sum(1)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    lib = _build.load()
    rc = lib.similarity_launch(
        x.data_ptr(), y.data_ptr(), xx.data_ptr(), yy.data_ptr(), out.data_ptr(),
        n, m, d, _METRIC_CODE[metric], inv2s2,
        _build.raw_stream(x),
    )
    _build.check(rc, "similarity kernel")
    return out
