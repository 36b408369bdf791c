"""Public wrappers around the port's CUDA kernels.

On a CUDA tensor each wrapper launches its hand-written kernel (built at
first use, see ``_build.py``) or raises; it never falls back.  On a CPU
tensor it runs the kernel's plain PyTorch version (the dense FL, GC,
disparity and coverage sweeps add in the kernel's order; the matrix-free
and fused ones agree with theirs to a tolerance).  Each wrapper checks device, dtype
(fp32; the fused sweep also takes bf16 features), shape and contiguity and raises on
anything its kernel does not take.

``LAUNCHES`` counts kernel launches per wrapper (one per call that reached
the card), so a run can prove that its path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.common import CONCAVE_FNS
from repro_torch.kernels.disp_gains import (
    dmin_gains_cuda,
    dmin_gains_plain,
    dsum_gains_cuda,
    dsum_gains_plain,
)
from repro_torch.kernels.fb_gains import (
    fb_gains_at_cuda,
    fb_gains_at_plain,
    fb_gains_cuda,
    fb_gains_plain,
)
from repro_torch.kernels.fl_gains import (
    fl_gains_at_cuda,
    fl_gains_at_plain,
    fl_gains_cuda,
    fl_gains_plain,
)
from repro_torch.kernels.flmf_gains import (
    flmf_gains_at_cuda,
    flmf_gains_at_plain,
    flmf_gains_cuda,
    flmf_gains_plain,
)
from repro_torch.kernels.fused_fl_sweep import (
    DTYPES as FUSED_DTYPES,
    fused_fl_sweep_cuda,
    fused_fl_sweep_plain,
)
from repro_torch.kernels.gc_gains import (
    gc_gains_at_cuda,
    gc_gains_at_plain,
    gc_gains_cuda,
    gc_gains_plain,
)
from repro_torch.kernels.gcmf_gains import (
    gcmf_gains_at_cuda,
    gcmf_gains_at_plain,
    gcmf_gains_cuda,
    gcmf_gains_plain,
)
from repro_torch.kernels.sc_gains import (
    psc_gains_cuda,
    psc_gains_plain,
    sc_gains_cuda,
    sc_gains_plain,
)
from repro_torch.kernels.similarity_kernel import (
    METRICS,
    similarity_cuda,
    similarity_plain,
)

LAUNCHES: dict[str, int] = {
    "similarity": 0,
    "fl_gains": 0,
    "fl_gains_at": 0,
    "flmf_gains": 0,
    "flmf_gains_at": 0,
    "gcmf_gains": 0,
    "gcmf_gains_at": 0,
    "gc_gains": 0,
    "gc_gains_at": 0,
    "dsum_gains": 0,
    "dmin_gains": 0,
    "fb_gains": 0,
    "fb_gains_at": 0,
    "sc_gains": 0,
    "psc_gains": 0,
    "fused_fl_sweep": 0,
}


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


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; choose from {METRICS}")


def _check_concave(concave: str) -> None:
    if concave not in CONCAVE_FNS:
        raise ValueError(f"unknown concave fn {concave!r}; choose from {sorted(CONCAVE_FNS)}")


def _check_len(name: str, t: torch.Tensor, n: int, of: str) -> None:
    if t.shape[0] != n:
        raise ValueError(f"{name} {tuple(t.shape)} does not match the {n} {of}")


def _check_idx(idx, like: torch.Tensor) -> None:
    if not isinstance(idx, torch.Tensor) or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError("idx must be an int32 or int64 torch.Tensor")
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
    if idx.device != like.device:
        raise ValueError(f"idx on {idx.device}, inputs on {like.device}")


def _check_scalar(name: str, t, dtype: torch.dtype) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.numel() != 1:
        raise TypeError(f"{name} must be a one-element {dtype} torch.Tensor")


def _check_square(name: str, t) -> None:
    _check_f32(name, t, 2)
    if t.shape[0] != t.shape[1]:
        raise ValueError(f"{name} must be square (n, n), got shape {tuple(t.shape)}")


def similarity(x, y, metric: str = "dot", rbf_sigma: float | None = None) -> torch.Tensor:
    """(n, d), (m, d) fp32 -> (n, m) similarity (dot / cosine / euclidean / rbf)."""
    _check_metric(metric)
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
    _check_idx(idx, sim)
    if not on_card:
        return fl_gains_at_plain(sim, curmax, idx)
    out = fl_gains_at_cuda(sim, curmax, idx.to(torch.int32).contiguous())
    LAUNCHES["fl_gains_at"] += 1
    return out


def _check_flmf(x, y, xx, yy, curmax, metric) -> bool:
    _check_metric(metric)
    _check_f32("x", x, 2)
    _check_f32("y", y, 2)
    if x.shape[1] != y.shape[1] or x.shape[1] == 0:
        raise ValueError(f"feature widths differ or are 0: x {tuple(x.shape)}, y {tuple(y.shape)}")
    for name, t, like in (("xx", xx, "x"), ("curmax", curmax, "x"), ("yy", yy, "y")):
        _check_f32(name, t, 1)
        _check_len(name, t, (x if like == "x" else y).shape[0], f"rows of {like}")
    return _on_card(("x", x), ("y", y), ("xx", xx), ("yy", yy), ("curmax", curmax))


def flmf_gains(x, y, xx, yy, curmax, metric: str = "dot", rbf_sigma: float | None = None):
    """Matrix-free FL sweep: x (u, d) represented rows, y (n, d) candidates
    (cosine rows pre-normalised), xx (u,) / yy (n,) their sums of squares,
    curmax (u,) -> gains (n,): sum_i max(metric(x_i, y_j) - curmax_i, 0)."""
    if not _check_flmf(x, y, xx, yy, curmax, metric):
        return flmf_gains_plain(x, y, xx, yy, curmax, metric, rbf_sigma)
    out = flmf_gains_cuda(x, y, xx, yy, curmax, metric, rbf_sigma)
    LAUNCHES["flmf_gains"] += 1
    return out


def flmf_gains_at(x, y, xx, yy, curmax, idx, metric: str = "dot", rbf_sigma: float | None = None):
    """Gathered matrix-free FL sweep: idx (k,) integer -> gains (k,); idx < 0
    -> NEG_INF, bit-identical to :func:`flmf_gains` at the same indices."""
    on_card = _check_flmf(x, y, xx, yy, curmax, metric)
    _check_idx(idx, y)
    if y.shape[0] == 0 and idx.shape[0]:
        raise ValueError("flmf_gains_at: y has no rows to gather from")
    if not on_card:
        return flmf_gains_at_plain(x, y, xx, yy, curmax, idx, metric, rbf_sigma)
    idx32 = idx.to(torch.int32).contiguous()
    out = flmf_gains_at_cuda(x, y, xx, yy, curmax, idx32, metric, rbf_sigma)
    LAUNCHES["flmf_gains_at"] += 1
    return out


def _check_gcmf(y, yy, selmask, total, diag, lam, metric) -> bool:
    _check_metric(metric)
    _check_f32("y", y, 2)
    if y.shape[1] == 0:
        raise ValueError(f"y has feature width 0: {tuple(y.shape)}")
    for name, t in (("yy", yy), ("selmask", selmask), ("total", total), ("diag", diag)):
        _check_f32(name, t, 1)
        _check_len(name, t, y.shape[0], "rows of y")
    _check_scalar("lam", lam, torch.float32)
    return _on_card(("y", y), ("yy", yy), ("selmask", selmask), ("total", total),
                    ("diag", diag), ("lam", lam))


def gcmf_gains(y, yy, selmask, total, diag, lam, metric: str = "dot",
               rbf_sigma: float | None = None):
    """Stateless matrix-free GC sweep: y (n, d) ground rows (cosine rows
    pre-normalised), yy (n,) their sums of squares, selmask (n,) 0/1,
    total / diag (n,), lam one-element tensor -> gains (n,):
    total_j - lam * (2 * sum_k metric(y_j, y_k) * m_k + diag_j)."""
    if not _check_gcmf(y, yy, selmask, total, diag, lam, metric):
        return gcmf_gains_plain(y, yy, selmask, total, diag, lam, metric, rbf_sigma)
    out = gcmf_gains_cuda(y, yy, selmask, total, diag, lam, metric, rbf_sigma)
    LAUNCHES["gcmf_gains"] += 1
    return out


def gcmf_gains_at(y, yy, selmask, total, diag, lam, idx, metric: str = "dot",
                  rbf_sigma: float | None = None):
    """Gathered matrix-free GC sweep: idx (k,) integer -> gains (k,); idx < 0
    -> NEG_INF, bit-identical to :func:`gcmf_gains` at the same indices."""
    on_card = _check_gcmf(y, yy, selmask, total, diag, lam, metric)
    _check_idx(idx, y)
    if y.shape[0] == 0 and idx.shape[0]:
        raise ValueError("gcmf_gains_at: y has no rows to gather from")
    if not on_card:
        return gcmf_gains_at_plain(y, yy, selmask, total, diag, lam, idx, metric, rbf_sigma)
    idx32 = idx.to(torch.int32).contiguous()
    out = gcmf_gains_at_cuda(y, yy, selmask, total, diag, lam, idx32, metric, rbf_sigma)
    LAUNCHES["gcmf_gains_at"] += 1
    return out


def _check_gc(sim, selmask, total, lam) -> bool:
    _check_square("sim", sim)
    for name, t in (("selmask", selmask), ("total", total)):
        _check_f32(name, t, 1)
        _check_len(name, t, sim.shape[0], "rows of sim")
    _check_scalar("lam", lam, torch.float32)
    return _on_card(("sim", sim), ("selmask", selmask), ("total", total), ("lam", lam))


def gc_gains(sim, selmask, total, lam) -> torch.Tensor:
    """Stateless dense GC sweep: sim (n, n) ground kernel, selmask (n,) 0/1,
    total (n,), lam one-element tensor -> gains (n,):
    total_j - lam * sum_k sim_jk * (2 * m_k + [j == k])."""
    if not _check_gc(sim, selmask, total, lam):
        return gc_gains_plain(sim, selmask, total, lam)
    out = gc_gains_cuda(sim, selmask, total, lam)
    LAUNCHES["gc_gains"] += 1
    return out


def gc_gains_at(sim, selmask, total, lam, idx) -> torch.Tensor:
    """Gathered dense GC sweep: idx (k,) integer -> gains (k,); idx < 0 ->
    NEG_INF, idx >= n reads row n - 1; bit-identical to :func:`gc_gains` at
    the same indices."""
    on_card = _check_gc(sim, selmask, total, lam)
    _check_idx(idx, sim)
    if sim.shape[0] == 0 and idx.shape[0]:
        raise ValueError("gc_gains_at: sim has no rows to gather from")
    if not on_card:
        return gc_gains_at_plain(sim, selmask, total, lam, idx)
    out = gc_gains_at_cuda(sim, selmask, total, lam, idx.to(torch.int32).contiguous())
    LAUNCHES["gc_gains_at"] += 1
    return out


def _check_disp(dist, selmask) -> None:
    _check_square("dist", dist)
    _check_f32("selmask", selmask, 1)
    _check_len("selmask", selmask, dist.shape[0], "rows of dist")


def dsum_gains(dist, selmask) -> torch.Tensor:
    """DisparitySum sweep: dist (n, n), selmask (n,) 0/1 -> gains (n,):
    sum_k dist_jk * m_k."""
    _check_disp(dist, selmask)
    if not _on_card(("dist", dist), ("selmask", selmask)):
        return dsum_gains_plain(dist, selmask)
    out = dsum_gains_cuda(dist, selmask)
    LAUNCHES["dsum_gains"] += 1
    return out


def dmin_gains(dist, selmask, count, curmin) -> torch.Tensor:
    """DisparityMin sweep: dist (n, n), selmask (n,) 0/1, count one-element
    int32 |A|, curmin one-element fp32 f(A) -> gains (n,):
    min(count == 0 ? 0 : min_{k: m_k > 0} dist_jk, BIG) - curmin."""
    _check_disp(dist, selmask)
    _check_scalar("count", count, torch.int32)
    _check_scalar("curmin", curmin, torch.float32)
    if not _on_card(("dist", dist), ("selmask", selmask), ("count", count), ("curmin", curmin)):
        return dmin_gains_plain(dist, selmask, count, curmin)
    out = dmin_gains_cuda(dist, selmask, count, curmin)
    LAUNCHES["dmin_gains"] += 1
    return out


def _check_cols(mat_name: str, mat, **vecs) -> None:
    """``mat`` an fp32 (n, F) matrix with F > 0, each of ``vecs`` an fp32
    (F,) vector."""
    _check_f32(mat_name, mat, 2)
    if mat.shape[1] == 0:
        raise ValueError(f"{mat_name} has no columns: {tuple(mat.shape)}")
    for name, t in vecs.items():
        _check_f32(name, t, 1)
        _check_len(name, t, mat.shape[1], f"columns of {mat_name}")


def _check_fb(feats, acc, w, concave) -> bool:
    _check_concave(concave)
    _check_cols("feats", feats, acc=acc, w=w)
    return _on_card(("feats", feats), ("acc", acc), ("w", w))


def fb_gains(feats, acc, w, concave: str = "sqrt") -> torch.Tensor:
    """FeatureBased sweep: feats (n, F) non-negative, acc (F,) feature mass
    m_f(A), w (F,) weights -> gains (n,): sum_f w_f (g(acc_f + X_jf) -
    g(acc_f)), g the ``concave`` of ``common.CONCAVE_FNS``."""
    if not _check_fb(feats, acc, w, concave):
        return fb_gains_plain(feats, acc, w, concave)
    out = fb_gains_cuda(feats, acc, w, concave)
    LAUNCHES["fb_gains"] += 1
    return out


def fb_gains_at(feats, acc, w, idx, concave: str = "sqrt") -> torch.Tensor:
    """Gathered FeatureBased sweep: idx (k,) integer -> gains (k,); idx < 0
    -> NEG_INF, idx >= n reads row n - 1; bit-identical to :func:`fb_gains`
    at the same indices."""
    on_card = _check_fb(feats, acc, w, concave)
    _check_idx(idx, feats)
    if feats.shape[0] == 0 and idx.shape[0]:
        raise ValueError("fb_gains_at: feats has no rows to gather from")
    if not on_card:
        return fb_gains_at_plain(feats, acc, w, idx, concave)
    out = fb_gains_at_cuda(feats, acc, w, idx.to(torch.int32).contiguous(), concave)
    LAUNCHES["fb_gains_at"] += 1
    return out


def sc_gains(cover, covered, w) -> torch.Tensor:
    """SetCover sweep: cover (n, m) 0/1 incidence, covered (m,) covered
    indicator, w (m,) concept weights -> gains (n,):
    sum_u w_u max(G_ju - covered_u, 0)."""
    _check_cols("cover", cover, covered=covered, w=w)
    if not _on_card(("cover", cover), ("covered", covered), ("w", w)):
        return sc_gains_plain(cover, covered, w)
    out = sc_gains_cuda(cover, covered, w)
    LAUNCHES["sc_gains"] += 1
    return out


def psc_gains(probs, miss, w) -> torch.Tensor:
    """ProbabilisticSetCover sweep: probs (n, m), miss (m,) the memoized
    miss probabilities prod_{i in A} (1 - p_iu), w (m,) -> gains (n,):
    sum_u (w_u miss_u) p_ju, with w * miss formed once here, on the
    inputs' device."""
    _check_cols("probs", probs, miss=miss, w=w)
    on_card = _on_card(("probs", probs), ("miss", miss), ("w", w))
    wm = w * miss
    if not on_card:
        return psc_gains_plain(probs, wm)
    out = psc_gains_cuda(probs, wm)
    LAUNCHES["psc_gains"] += 1
    return out


def fused_fl_sweep(x, y, curmax) -> torch.Tensor:
    """Fused dot similarity + FL sweep: x (u, d) represented rows and y (n, d)
    candidates, each fp32 or bf16 (read as they are, no fp32 copy), curmax
    (u,) fp32 -> gains (n,) fp32: sum_i max(<x_i, y_j> - curmax_i, 0).
    Cosine callers pre-normalise the rows."""
    for name, t in (("x", x), ("y", y)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in FUSED_DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape[1] != y.shape[1] or x.shape[1] == 0:
        raise ValueError(f"feature widths differ or are 0: x {tuple(x.shape)}, y {tuple(y.shape)}")
    _check_f32("curmax", curmax, 1)
    _check_len("curmax", curmax, x.shape[0], "rows of x")
    if not _on_card(("x", x), ("y", y), ("curmax", curmax)):
        return fused_fl_sweep_plain(x, y, curmax)
    out = fused_fl_sweep_cuda(x, y, curmax)
    LAUNCHES["fused_fl_sweep"] += 1
    return out
