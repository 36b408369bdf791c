"""Public wrappers around the port's CUDA kernels.

On a CUDA tensor each wrapper launches its hand-written kernel (built at
first use, see ``_build.py``) or raises; it never falls back.  On a CPU
tensor it runs the kernel's plain PyTorch version, which adds in the same
order.  Each wrapper checks device, dtype (fp32), shape and contiguity and
raises on anything its kernel does not take.

``LAUNCHES`` counts kernel launches per wrapper (one per call that reached
the card), so a run can prove that its path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fl_gains import (
    fl_gains_at_cuda,
    fl_gains_at_plain,
    fl_gains_cuda,
    fl_gains_plain,
)
from repro_torch.kernels.similarity_kernel import (
    METRICS,
    similarity_cuda,
    similarity_plain,
)

LAUNCHES: dict[str, int] = {"similarity": 0, "fl_gains": 0, "fl_gains_at": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_f32(name: str, t, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_card(*named: tuple[str, torch.Tensor]) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises on a mix or on
    any other device."""
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(
            "inputs on different devices: "
            + ", ".join(f"{n}={t.device}" for n, t in named)
        )
    (dev,) = devices
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}; use a CUDA or CPU tensor")
    return dev.type == "cuda"


def similarity(x, y, metric: str = "dot", rbf_sigma: float | None = None) -> torch.Tensor:
    """(n, d), (m, d) fp32 -> (n, m) similarity (dot / cosine / euclidean / rbf)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; choose from {METRICS}")
    _check_f32("x", x, 2)
    _check_f32("y", y, 2)
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"feature widths differ: x {tuple(x.shape)}, y {tuple(y.shape)}")
    if not _on_card(("x", x), ("y", y)):
        return similarity_plain(x, y, metric, rbf_sigma)
    out = similarity_cuda(x, y, metric, rbf_sigma)
    LAUNCHES["similarity"] += 1
    return out


def _check_fl(sim, curmax) -> bool:
    _check_f32("sim", sim, 2)
    _check_f32("curmax", curmax, 1)
    if curmax.shape[0] != sim.shape[0]:
        raise ValueError(f"curmax {tuple(curmax.shape)} does not match sim rows {sim.shape[0]}")
    return _on_card(("sim", sim), ("curmax", curmax))


def fl_gains(sim, curmax) -> torch.Tensor:
    """sim (u, n), curmax (u,) -> gains (n,): sum_i max(sim_ij - curmax_i, 0)."""
    if not _check_fl(sim, curmax):
        return fl_gains_plain(sim, curmax)
    out = fl_gains_cuda(sim, curmax)
    LAUNCHES["fl_gains"] += 1
    return out


def fl_gains_at(sim, curmax, idx) -> torch.Tensor:
    """Gathered sweep: idx (k,) integer -> gains (k,); idx < 0 -> NEG_INF,
    bit-identical to :func:`fl_gains` at the same indices."""
    on_card = _check_fl(sim, curmax)
    if not isinstance(idx, torch.Tensor) or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError("idx must be an int32 or int64 torch.Tensor")
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
    if idx.device != sim.device:
        raise ValueError(f"idx on {idx.device}, sim on {sim.device}")
    if not on_card:
        return fl_gains_at_plain(sim, curmax, idx)
    out = fl_gains_at_cuda(sim, curmax, idx.to(torch.int32).contiguous())
    LAUNCHES["fl_gains_at"] += 1
    return out
