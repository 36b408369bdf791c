"""Feature-based (concave-over-modular) gain sweeps: the CUDA kernel's
launchers and their plain versions.

``gains_j = sum_f w_f * (g(acc_f + X[j, f]) - g(acc_f))`` over the (n, F)
feature matrix X, with g one of ``common.CONCAVE_FNS`` (sqrt / log /
inverse), for every candidate (``fb_gains``, the port of
``repro/kernels/fb_gains.py::fb_gains_pallas``) or for the rows ``idx``
(``fb_gains_at``, the port of ``fb_gains_at_pallas``; slots with idx < 0
return NEG_INF, idx >= n reads row n - 1).  The full sweep forms ``g(acc)``
once per feature; the gathered sweep, one launch, forms it in its term.

The kernel (``csrc/fb_gains.cu``) and the plain versions below sum each row
in ``row_reduce``'s warp layout with the same rounding steps, so the
gathered sweep equals the full sweep bit for bit at the same index.  On the
card the plain versions take torch's sqrt, log1p and division, which round
as the kernel's do, so kernel and plain version agree bit for bit there.
Torch's CPU sqrt is not correctly rounded and its log1p is another
implementation than CUDA's log1pf (each gives one value wherever an element
sits), so on the CPU the plain versions can differ from the kernel's
results by an ulp per term.
"""
from __future__ import annotations

import torch

from repro_torch.common import NEG_INF, get_concave
from repro_torch.kernels import _build
from repro_torch.kernels.row_reduce import reduce_rows_warp

CONCAVE_CODES = {"sqrt": 0, "log": 1, "inverse": 2}  # csrc/fb_gains.cu's Concave


def _plain(feats, acc, w, concave, rows) -> torch.Tensor:
    g = get_concave(concave)
    base = g(acc)

    def term(s, lo, hi):
        return (g(acc[lo:hi] + s) - base[lo:hi]) * w[lo:hi]

    return reduce_rows_warp(feats, rows, term)


def fb_gains_plain(feats: torch.Tensor, acc: torch.Tensor, w: torch.Tensor,
                   concave: str = "sqrt") -> torch.Tensor:
    """feats (n, F), acc / w (F,) -> gains (n,) fp32, in plain PyTorch;
    holds one (n, 32) block of terms at a time."""
    return _plain(feats, acc, w, concave, None)


def fb_gains_at_plain(feats: torch.Tensor, acc: torch.Tensor, w: torch.Tensor,
                      idx: torch.Tensor, concave: str = "sqrt") -> torch.Tensor:
    """Gathered sweep in plain PyTorch: idx (k,) -> gains (k,); idx < 0 ->
    NEG_INF, bit-identical to :func:`fb_gains_plain` at the same index."""
    idx = idx.to(device=feats.device, dtype=torch.long)
    g = _plain(feats, acc, w, concave, torch.clamp(idx, 0, feats.shape[0] - 1))
    return torch.where(idx < 0, NEG_INF, g)


def _launch(feats, acc, w, concave, idx) -> torch.Tensor:
    n, F = feats.shape
    k = n if idx is None else idx.shape[0]
    out = torch.empty((k,), dtype=torch.float32, device=feats.device)
    if k == 0:
        return out
    # g(acc), formed once per feature by the full sweep; the gathered sweep
    # forms it in its term and takes no scratch
    ga = None if idx is not None else torch.empty((F,), dtype=torch.float32, device=feats.device)
    rc = _build.load().fb_gains_launch(
        feats.data_ptr(), n, F, acc.data_ptr(), w.data_ptr(), CONCAVE_CODES[concave],
        None if idx is None else idx.data_ptr(), 0 if idx is None else idx.element_size(), k,
        None if ga is None else ga.data_ptr(), out.data_ptr(), _build.raw_stream(feats),
    )
    _build.check(rc, "fb_gains kernel")
    return out


def fb_gains_cuda(feats, acc, w, concave: str = "sqrt") -> torch.Tensor:
    """Launch the full sweep on checked CUDA tensors (see ``ops.fb_gains``)."""
    return _launch(feats, acc, w, concave, None)


def fb_gains_at_cuda(feats, acc, w, idx, concave: str = "sqrt") -> torch.Tensor:
    """Launch the gathered sweep; ``idx`` is a contiguous int32 or int64
    CUDA tensor, taken as it is."""
    return _launch(feats, acc, w, concave, idx)
