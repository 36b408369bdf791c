"""On-device mask compaction (``csrc/select_cols.cu``): the ascending int32
list of the columns a selection mask picks, and their count, both on the
mask's device.

``pred`` is ``"positive"`` (``m_c > 0``, DisparityMin's masked min) or
``"nonzero"`` (``m_c != 0``, the terms of the masked sums of GraphCut,
GraphCutMF and DisparitySum).  The dmin and gcmf kernels take the list
and its count from here, and the gc and dsum launchers run the kernel
themselves into a :func:`scratch` of their caller's, so that they read only
the selected columns, and a greedy step never waits on the host: the count
stays in device memory.  The kernel scans with integer sums and
no atomics, so the list is the same on every run; its plain version is
``torch.nonzero``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

CHUNK = _build.SELECT_CHUNK  # mask elements per block of the kernel's scan
PREDICATES = {"positive": 0, "nonzero": 1}


def picked_cols(mask: torch.Tensor, pred: str) -> torch.Tensor:
    """The picked columns of mask (n,) in ascending order, int64: the list
    without its padding, for the kernels' plain versions."""
    return torch.nonzero(mask > 0.0 if pred == "positive" else mask != 0.0).flatten()


def select_cols_plain(mask: torch.Tensor, pred: str) -> tuple[torch.Tensor, torch.Tensor]:
    """mask (n,) -> (sel (n,) int32, count one-element int32): sel[:count]
    are the picked columns in ascending order, the rest 0."""
    picked = picked_cols(mask, pred)
    sel = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    sel[: picked.numel()] = picked.to(torch.int32)
    return sel, torch.tensor([picked.numel()], dtype=torch.int32, device=mask.device)


def scratch(n: int, device) -> tuple[torch.Tensor, int, int]:
    """One compaction's int32 scratch on ``device``: the list (n,), then the
    per-chunk counts and, last, the count; with the pointers ``sel`` and
    ``blk`` that ``select_cols_launch`` (and the gc / dsum launchers, which
    run it themselves) take."""
    buf = torch.empty((n + -(-n // CHUNK) + 1,), dtype=torch.int32, device=device)
    return buf, buf.data_ptr(), buf.data_ptr() + 4 * n


def select_cols_cuda(mask: torch.Tensor, pred: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel, on a contiguous fp32 CUDA mask with 1 <= n <= 2^31 - 1:
    as :func:`select_cols_plain`, with sel past count left as scratch."""
    n = mask.shape[0]
    buf, sel, blk = scratch(n, mask.device)
    rc = _build.load().select_cols_launch(
        mask.data_ptr(), n, PREDICATES[pred], sel, blk,
        torch.cuda.current_stream(mask.device).cuda_stream,
    )
    _build.check(rc, "select_cols kernel")
    return buf[:n], buf[-1:]


def select_cols(mask: torch.Tensor, pred: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The compaction of an fp32 (n,) mask: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if pred not in PREDICATES:
        raise ValueError(f"unknown predicate {pred!r}; choose from {sorted(PREDICATES)}")
    if mask.dtype != torch.float32 or mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous 1-D float32 tensor")
    if mask.device.type == "cuda" and mask.shape[0] > 0:
        return select_cols_cuda(mask, pred)
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {mask.device}")
    return select_cols_plain(mask, pred)
